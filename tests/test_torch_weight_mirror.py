"""The weight mirror's path of the train step against the cast-at-use
path, on the CPU (openeat_torch/utils/weight_mirror.py,
openeat_torch/ops/multi_tensor.py).

A tiny Conformer in bfloat16 (d 64, 2 blocks, dropout 0.1), two copies
of the same weights, each with its own dropout generator of one seed:
one trains through the mirror, the other through the train step's own
path (the mirror refused to it). Over three updates at accum_grad 1 and
4 the losses and the float32 gradients before the clip are bit-equal,
and the parameters and Adam's moments agree within the norm's summation
order (relative 1e-6; on the CPU the plain versions give the same bits).
A probe counts the parameter casts of a training forward; a parameter
written in place between steps is read fresh, also by an update of the
step's own path (the benchmark's breakdown composes the step's functions
without the mirror); a non-finite gradient leaves the state as it was;
only_adapter keeps the frozen parameters in the norm; float32 models,
SGD and a mesh take no mirror; another thread's forward casts. The plain
versions of the kernels are held to torch.optim.Adam and AdamW.
"""

import copy
import math
import threading

import numpy as np
import pytest
import torch
from torch import nn
from torch.overrides import TorchFunctionMode

from openeat_torch.models.asr_model import build_asr_model, init_parameters
from openeat_torch.ops import multi_tensor as mt
from openeat_torch.parallel import train_step as ts
from openeat_torch.utils import weight_mirror as wm
from openeat_torch.utils.common import make_generator
from openeat_torch.utils.optim import build_optimizer

torch.set_num_threads(1)
FEAT, VOCAB = 80, 40
CONF = dict(d_model=64, attention_heads=4, linear_units=128,
            encoder_num_blocks=2, decoder_num_blocks=1,
            r_decoder_num_blocks=1, cnn_module_kernel=15,
            input_layer="conv2d", pos_enc_layer_type="rel_pos",
            macaron_style=True, use_cnn_module=True, reverse_weight=0.3,
            compute_dtype="bfloat16", dropout_rate=0.1)


def _model(seed=0, **overrides) -> nn.Module:
    model = build_asr_model(dict(CONF, **overrides), FEAT, VOCAB)
    init_parameters(model, make_generator(seed))
    with torch.no_grad():   # biases and norms off their constant init
        g = make_generator(seed + 1)
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


def _micro(seed, b=3, t=57) -> dict:
    rng = np.random.default_rng(seed)
    ys = rng.integers(1, VOCAB - 1, (b, 8))
    ys_lens = np.array([8, 3, 6][:b])
    for i, n in enumerate(ys_lens):
        ys[i, n:] = -1
    return {"features": torch.from_numpy(
                rng.standard_normal((b, t, FEAT)).astype(np.float32)),
            "features_length": torch.tensor([t, t - 16, 23][:b],
                                            dtype=torch.int32),
            "targets": torch.from_numpy(ys.astype(np.int32)),
            "targets_length": torch.from_numpy(ys_lens.astype(np.int32))}


def _batch(step: int, accum: int) -> dict:
    if accum == 1:
        return _micro(step)
    micro = [_micro(10 * step + i) for i in range(accum)]
    return {k: torch.stack([m[k] for m in micro]) for k in micro[0]}


@pytest.fixture
def cast_path(monkeypatch):
    """Refuse the mirror to the models added to the returned set."""
    refused = set()
    build = wm._build

    def refusing(model, optimizer):
        return None if id(model) in refused else build(model, optimizer)
    monkeypatch.setattr(wm, "_build", refusing)
    return refused


def _step(state, schedule, batch, accum, gen, clip=5.0, mirror=True):
    """One train step as build_train_step composes it (without the mirror
    where `mirror` is False), with the gradients before the clip:
    (metrics, {name: grad}, norm, applied)."""
    model = state.model
    model.train()
    ts.set_generator(model, gen)
    model.zero_grad(set_to_none=True)
    m = wm.for_step(state) if mirror else None
    metrics = ts._loss_and_grads(model, batch, accum, ts.asr_loss, m)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    gnorm, applied = ts.apply_update(state, schedule, clip)
    return metrics, grads, gnorm, applied


def _adam_state(state):
    names = dict((id(p), n) for n, p in state.model.named_parameters())
    return {names[id(p)]: st for p, st in state.optimizer.state.items()}


@pytest.mark.parametrize("accum", [1, 4])
def test_mirror_path_matches_the_cast_path(cast_path, accum):
    base = _model()
    mirror_model, cast_model = copy.deepcopy(base), copy.deepcopy(base)
    cast_path.add(id(cast_model))
    states = []
    for m in (mirror_model, cast_model):
        opt, schedule = build_optimizer(m, 1e-3, 3)
        states.append(ts.TrainState(m, opt))
    gens = [make_generator(5), make_generator(5)]
    for step in range(3):
        batch = _batch(step, accum)
        (ma, ga, na, aa), (mb, gb, nb, ab) = (
            _step(s, schedule, batch, accum, g) for s, g in zip(states, gens))
        assert states[0].mirror is not None and states[1].mirror is None
        assert aa and ab
        assert torch.equal(ma["loss"], mb["loss"])
        assert all(torch.equal(ga[k], gb[k]) for k in ga), step
        assert float(na) == pytest.approx(float(nb), rel=1e-6)
        pa = dict(mirror_model.named_parameters())
        pb = dict(cast_model.named_parameters())
        sa, sb = _adam_state(states[0]), _adam_state(states[1])
        for k in pa:
            torch.testing.assert_close(pa[k], pb[k], rtol=1e-6, atol=0)
            for key in ("exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(sa[k][key], sb[k][key],
                                           rtol=1e-6, atol=0)
            assert float(sa[k]["step"]) == float(sb[k]["step"]) == step + 1
        # the mirror holds the parameters' bf16 cast
        mirror = states[0].mirror
        assert all(torch.equal(c, p.to(torch.bfloat16)) for c, p in
                   zip(mirror.table.copies, mirror.params))
    assert states[0].n_applied == states[1].n_applied == 3


def test_train_step_runs_the_mirror_path_end_to_end(cast_path):
    """build_train_step itself: the same metrics on both paths."""
    base = _model(3)
    models = [copy.deepcopy(base), copy.deepcopy(base)]
    cast_path.add(id(models[1]))
    out = []
    for m in models:
        opt, schedule = build_optimizer(m, 1e-3, 3)
        state = ts.TrainState(m, opt)
        step = ts.build_train_step(schedule, 1, 5.0)
        gen = make_generator(9)
        out.append([step(state, _micro(s), gen) for s in range(3)])
    for a, b in zip(*out):
        assert torch.equal(a["loss"], b["loss"])
        assert float(a["grad_norm"]) == pytest.approx(float(b["grad_norm"]),
                                                      rel=1e-6)
        assert float(a["skipped"]) == float(b["skipped"]) == 0.0


class _CastProbe(TorchFunctionMode):
    """Counts Tensor.to calls on parameters."""

    def __init__(self):
        super().__init__()
        self.casts = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.to and isinstance(args[0], nn.Parameter):
            self.casts += 1
        return func(*args, **(kwargs or {}))


def test_a_training_forward_casts_no_parameter():
    model = _model()
    opt, schedule = build_optimizer(model, 1e-3, 3)
    state = ts.TrainState(model, opt)
    step = ts.build_train_step(schedule, 1, 5.0)
    gen = make_generator(1)
    step(state, _micro(0), gen)
    with _CastProbe() as probe:
        step(state, _micro(1), gen)
    assert probe.casts == 0
    # the probe sees the casts where no mirror is read
    with _CastProbe() as probe, torch.no_grad():
        model.eval()
        model(*_micro(2).values())
    assert probe.casts > 100


def test_a_parameter_written_between_steps_is_read_fresh(cast_path):
    base = _model()
    models = [copy.deepcopy(base), copy.deepcopy(base)]
    cast_path.add(id(models[1]))
    states, gens = [], []
    for m in models:
        opt, schedule = build_optimizer(m, 1e-3, 3)
        states.append(ts.TrainState(m, opt))
        gens.append(make_generator(2))
    for s, g in zip(states, gens):
        _step(s, schedule, _micro(0), 1, g)
    for m in models:   # a write outside the update, as a load makes
        with torch.no_grad():
            dict(m.named_parameters())[
                "encoder.encoders.layer_0.feed_forward.w_1.weight"].mul_(1.5)
    ma, ga, _, _ = _step(states[0], schedule, _micro(1), 1, gens[0])
    mb, gb, _, _ = _step(states[1], schedule, _micro(1), 1, gens[1])
    assert torch.equal(ma["loss"], mb["loss"])
    assert all(torch.equal(ga[k], gb[k]) for k in ga)
    mirror = states[0].mirror
    assert all(torch.equal(c, p.to(torch.bfloat16))
               for c, p in zip(mirror.table.copies, mirror.params))


def test_a_step_without_the_mirror_is_read_fresh(cast_path):
    """The benchmark's breakdown composes _loss_and_grads and
    apply_update without the mirror: that update takes the step's own
    path (torch.optim.Adam on the step counts' views), and the next
    mirror step reads its parameters and its Adam step."""
    base = _model()
    models = [copy.deepcopy(base), copy.deepcopy(base)]
    cast_path.add(id(models[1]))
    states, gens = [], []
    for m in models:
        opt, schedule = build_optimizer(m, 1e-3, 3)
        states.append(ts.TrainState(m, opt))
        gens.append(make_generator(3))
    for i, mirror in enumerate((True, False, True)):
        out = [_step(s, schedule, _micro(i), 1, g, mirror=mirror)
               for s, g in zip(states, gens)]
        (ma, ga, na, _), (mb, gb, nb, _) = out
        assert torch.equal(ma["loss"], mb["loss"]), i
        assert all(torch.equal(ga[k], gb[k]) for k in ga), i
        assert float(na) == pytest.approx(float(nb), rel=1e-6)
    assert states[0].mirror.pending is False
    sa, sb = _adam_state(states[0]), _adam_state(states[1])
    pa, pb = (dict(m.named_parameters()) for m in models)
    for k in pa:
        torch.testing.assert_close(pa[k], pb[k], rtol=1e-6, atol=0)
        assert float(sa[k]["step"]) == float(sb[k]["step"]) == 3.0
    assert all(torch.equal(c, p.to(torch.bfloat16)) for c, p in
               zip(states[0].mirror.table.copies, states[0].mirror.params))


def test_another_threads_forward_casts():
    model = _model()
    opt, _ = build_optimizer(model, 1e-3, 3)
    mirror = wm.for_step(ts.TrainState(model, opt))
    p = next(q for q in model.parameters() if q.dim() == 2)
    seen = {}

    def other():
        seen["other"] = wm.at_compute(p, torch.bfloat16)
    with wm.reading(mirror):
        t = threading.Thread(target=other)
        t.start()
        t.join()
        seen["mine"] = wm.at_compute(p, torch.bfloat16)
    assert seen["mine"] is mirror.leaves[p]
    assert seen["other"] is not mirror.leaves[p]
    assert torch.equal(seen["other"], seen["mine"])
    assert wm.at_compute(p, torch.bfloat16) is not mirror.leaves[p]


def test_load_state_dict_rebinds_the_update():
    model = _model()
    opt, schedule = build_optimizer(model, 1e-3, 3)
    state = ts.TrainState(model, opt)
    gen = make_generator(4)
    _step(state, schedule, _micro(0), 1, gen)
    first = state.mirror
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    _, _, _, applied = _step(state, schedule, _micro(1), 1, gen)
    mirror = state.mirror
    assert applied and mirror is not first and mirror.fits(opt)
    p = next(model.parameters())
    assert mirror.table.moments[0][0] is opt.state[p]["exp_avg"]
    assert float(opt.state[p]["step"]) == 2.0


def test_a_non_finite_gradient_leaves_the_state_unchanged():
    model = _model()
    opt, schedule = build_optimizer(model, 1e-3, 3)
    state = ts.TrainState(model, opt)
    step = ts.build_train_step(schedule, 1, 5.0)
    gen = make_generator(6)
    step(state, _micro(0), gen)
    mirror = state.mirror
    params = [p.detach().clone() for p in model.parameters()]
    adam = {id(p): {k: v.clone() for k, v in st.items()}
            for p, st in opt.state.items()}
    copies = mirror.table.mirror.clone()
    bad = _micro(1)
    bad["features"][0, 3, 5] = float("inf")
    metrics = step(state, bad, gen)
    assert float(metrics["skipped"]) == 1.0
    assert not math.isfinite(float(metrics["grad_norm"]))
    assert all(torch.equal(a, b) for a, b in zip(params, model.parameters()))
    for p, st in opt.state.items():
        for k, v in st.items():
            assert torch.equal(v, adam[id(p)][k]), k
    assert torch.equal(copies, mirror.table.mirror)
    assert (state.step, state.n_applied) == (2, 1)
    # the next finite step applies at the schedule's second value
    metrics = step(state, _micro(2), gen)
    assert float(metrics["skipped"]) == 0.0
    assert opt.param_groups[0]["lr"] == schedule(1)


def test_only_adapter_keeps_frozen_parameters_in_the_norm():
    model = _model(encoder_use_adapter=True, decoder_use_adapter=True)
    opt, schedule = build_optimizer(model, 1e-3, 3, only_adapter=True)
    state = ts.TrainState(model, opt)
    gen = make_generator(7)
    _step(state, schedule, _micro(0), 1, gen)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if "adapter" not in n}
    adapters = {n: p.detach().clone() for n, p in model.named_parameters()
                if "adapter" in n}
    _, grads, gnorm, applied = _step(state, schedule, _micro(1), 1, gen)
    assert applied and state.mirror is not None
    want = torch.stack([g.float().square().sum()
                        for g in grads.values()]).sum().sqrt()
    adapter_only = torch.stack([g.float().square().sum() for n, g in
                                grads.items() if "adapter" in n]).sum().sqrt()
    assert float(gnorm) == pytest.approx(float(want), rel=1e-6)
    assert float(gnorm) > 1.01 * float(adapter_only)
    params = dict(model.named_parameters())
    assert all(torch.equal(params[n], v) for n, v in frozen.items())
    assert any(not torch.equal(params[n], v) for n, v in adapters.items())


def test_other_models_and_optimizers_take_the_train_steps_path():
    f32 = _model(compute_dtype="float32")
    opt, _ = build_optimizer(f32, 1e-3, 3)
    assert wm.for_step(ts.TrainState(f32, opt)) is None
    bf16 = _model()
    sgd, schedule = build_optimizer(bf16, 1e-3, 3, optim="sgd")
    assert wm.for_step(ts.TrainState(bf16, sgd)) is None
    amsgrad = torch.optim.Adam(bf16.parameters(), 1e-3, amsgrad=True)
    assert wm.for_step(ts.TrainState(bf16, amsgrad)) is None
    adam, _ = build_optimizer(bf16, 1e-3, 3)
    on_adam = ts.TrainState(bf16, adam)
    assert wm.for_step(on_adam) is not None
    assert wm.for_step(on_adam, mesh=object()) is None
    assert on_adam.mirror is None   # dropped on the mesh
    # SGD trains through the step's own path, as before
    state = ts.TrainState(bf16, sgd)
    before = [p.detach().clone() for p in bf16.parameters()]
    metrics = ts.build_train_step(schedule, 1, 5.0)(state, _micro(0),
                                                    make_generator(8))
    assert float(metrics["skipped"]) == 0.0 and state.mirror is None
    assert any(not torch.equal(a, b) for a, b in zip(before,
                                                       bf16.parameters()))


# ---- the plain versions of the kernels

def _table(shapes, trainable, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = [torch.randn(s, generator=g) for s in shapes]
    moments = [(torch.randn(s, generator=g) * 1e-3,
                torch.rand(s, generator=g) * 1e-6) if t else None
               for s, t in zip(shapes, trainable)]
    return mt.ParamTable(params, moments)


def test_the_table_lays_parameters_end_to_end():
    t = _table([(3, 5), (7,), (2, 2, 2)], [True, False, True])
    assert t.offsets == [0, 16, 24] and t.total == 32
    assert t.first_block == [0, 1, 2, 3] and t.n_blocks == 3
    assert all(g.shape == p.shape for g, p in zip(t.grads, t.params))
    assert t.copies[2].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        mt.ParamTable([torch.zeros(3)], [(torch.zeros(3), torch.zeros(4))])
    with pytest.raises(ValueError):
        mt.ParamTable([torch.zeros(3, dtype=torch.float64)], [None])


def test_gather_sums_micro_batches_as_accumulate_grad_does():
    shapes = [(4, 3), (5,), (6,)]
    t = _table(shapes, [True] * 3)
    g = torch.Generator().manual_seed(1)
    micro = [([torch.randn(shapes[0], generator=g).bfloat16(), None,
               torch.randn(shapes[2], generator=g).bfloat16()],
              [None, torch.randn(shapes[1], generator=g),
               torch.randn(shapes[2], generator=g)]) for _ in range(3)]
    for i, (g16, g32) in enumerate(micro):
        mt.gather(t, g16, g32, first=i == 0, accum=3 if i == 2 else 1)
    for j in range(3):
        want = None
        for g16, g32 in micro:
            new = g16[j].float() if g16[j] is not None else None
            if g32[j] is not None:
                new = g32[j] if new is None else new + g32[j]
            want = new.clone() if want is None else want + new
        assert torch.equal(t.grads[j], want / 3), j
    # a parameter without a gradient in the first micro-batch reads 0
    mt.gather(t, [None] * 3, [None] * 3, first=True)
    assert not t.acc.any()


@pytest.mark.parametrize("norm", [0.5, 40.0])
def test_global_norm_and_clip_scale(norm):
    t = _table([(10,), (3, 4)], [True, True])
    with torch.no_grad():
        for g in t.grads:
            g.copy_(torch.linspace(-1, 1, g.numel()).view(g.shape))
        scale0 = norm / float(t.acc.norm())
        t.acc.mul_(scale0)
    out = mt.global_norm(t, 5.0)
    assert float(out[0]) == pytest.approx(norm, rel=1e-6)
    assert float(out[1]) == pytest.approx(min(1.0, 5.0 / norm), rel=1e-6)


@pytest.mark.parametrize("cls, kwargs", [
    (torch.optim.Adam, {}),
    (torch.optim.Adam, {"weight_decay": 0.01}),
    (torch.optim.AdamW, {"weight_decay": 0.01})])
def test_adam_plain_is_torch_optim_adam(cls, kwargs):
    shapes = [(6, 5), (7,)]
    t = _table(shapes, [True, True], seed=3)
    ref = [nn.Parameter(p.clone()) for p in t.params]
    opt = cls(ref, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, **kwargs)
    scale = torch.tensor(0.5)
    g = torch.Generator().manual_seed(4)
    for step in range(1, 4):
        with torch.no_grad():
            for acc in t.grads:
                acc.copy_(torch.randn(acc.shape, generator=g))
        for p, acc in zip(ref, t.grads):
            p.grad = acc * scale
        opt.step()
        decoupled = cls is torch.optim.AdamW
        h = mt.AdamHyper.of(1e-3, (0.9, 0.999), 1e-8,
                            kwargs.get("weight_decay", 0.0), decoupled, step)
        if step == 1:   # the optimizer's state starts at zero
            for m in t.moments:
                m[0].zero_()
                m[1].zero_()
        mt.adam(t, scale, h)
        for p, r, m, c in zip(t.params, ref, t.moments, t.copies):
            assert torch.equal(p, r.detach())
            assert torch.equal(m[0], opt.state[r]["exp_avg"])
            assert torch.equal(m[1], opt.state[r]["exp_avg_sq"])
            assert torch.equal(c, p.bfloat16())


def test_adam_leaves_entries_without_moments():
    t = _table([(5,), (4,)], [False, True])
    kept = t.params[0].clone()
    mt.write_mirror(t)
    mirror0 = t.copies[0].clone()
    t.acc.fill_(1.0)
    mt.adam(t, torch.tensor(1.0), mt.AdamHyper.of(
        1e-2, (0.9, 0.999), 1e-8, 0.0, False, 1))
    assert torch.equal(t.params[0], kept)
    assert torch.equal(t.copies[0], mirror0)
    assert not torch.equal(t.copies[1].float(), torch.zeros(4))
