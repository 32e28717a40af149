"""openeat_torch's pipeline parallelism against JAX's, on the CPU.

A gloo job of two ranks (pipe = 2) and one of four (data 2 x pipe 2)
run tests/_torch_dist_worker.py's `pp` tasks, while this process
computes the JAX references on the 8 virtual CPU devices that
tests/conftest.py provides: make_pp_loss_fn on a ('data', 'pipe') mesh
of (2, 2) and the sequential make_loss_fn. Float32, dropout 0, weights
and batches from numpy seeds (tests/_torch_parity.py's tiny Conformer:
d = 64, 4 heads, vocab 40; 2 blocks, or 4 applied as 2 shared layers),
8 rows a batch. Tolerances:
- losses and accuracy within 1e-5 relative;
- every gradient within 1e-4 of its tensor's largest plus 1e-7 of the
  model's largest (summation order: the microbatches, the ranks);
- one SGD step (lr 1, clip 5): every update within 1e-4 of its tensor's
  largest update plus 1e-7, as tests/test_torch_parallel.py;
- a weight-shared stack whose shared layer spans both stages (12
  applications of 3 physical layers, 4 each, at pipe 2: layer 1's
  applications 4-7 fall on both) against JAX's make_pp_loss_fn on the
  same stack: loss within 1e-6 relative, every gradient within the
  tolerance above, layer 1 held on both pipe ranks with bit-equal
  (summed) gradients; and one SGD step whose norm counts that layer
  once;
- one Adam step at data 2 x pipe 2 against the port's one-process step:
  the gathered first and second moments (the clipped gradient and its
  square) within the gradients' tolerance, every weight within 2 lr
  (Adam's first step moves a weight by about lr whatever the size of
  its gradient, so the weights show the gather, and the moments the
  numbers).
Each pipe rank holds only its stage's layers, and the replicated
parameters' gradients are bit-equal on the two pipe ranks.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from openeat_tpu.parallel.pipeline import make_pp_loss_fn as jax_pp_loss_fn
from openeat_tpu.parallel.train_step import make_loss_fn as jax_loss_fn
from openeat_tpu.utils.checkpoint import _flatten
from openeat_torch.parallel import pipeline
from openeat_torch.parallel.mesh import Mesh, stage_owner
from openeat_torch.parallel.train_step import TrainState, build_train_step
from openeat_torch.utils.optim import build_optimizer
from openeat_torch.utils.param_bridge import flax_to_state_dict
from tests._torch_jobs import spawn, wait
from tests._torch_parity import FEAT_DIM, TINY_CONF, VOCAB, tiny_models

torch.set_num_threads(1)
DENSE = dict(dropout_rate=0.0)
SHARED = dict(dropout_rate=0.0, encoder_num_blocks=4,
              encoder_num_blocks_share=2)
SPAN = dict(dropout_rate=0.0, encoder_num_blocks=12,
            encoder_num_blocks_share=4)
ADAM_LR = 1e-3


def _batch(seed, b=8, t=57):
    rng = np.random.default_rng(seed)
    ys_lens = rng.integers(2, 9, b).astype(np.int32)
    ys = rng.integers(1, VOCAB - 1, (b, 8)).astype(np.int32)
    for i, n in enumerate(ys_lens):
        ys[i, n:] = -1
    return {"features": rng.standard_normal((b, t, FEAT_DIM)).astype(
                np.float32),
            "features_length": rng.integers(t // 2, t + 1, b).astype(
                np.int32),
            "targets": ys, "targets_length": ys_lens}


def _jax_grads(loss_fn, variables, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, jb, jax.random.PRNGKey(1)), has_aux=True))(
        variables)
    return ({k: float(v) for k, v in metrics.items()},
            _flatten(jax.device_get(grads)))


def _local() -> Mesh:
    """A one-process mesh of pipe = 1 (no process group)."""
    return Mesh(1, 1, 0, 0, None, None)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_pipeline"))
    c = {"root": root, "models": {}}
    tasks = {2: [], 4: []}
    for name, conf, seed, bseed in (("dense", DENSE, 0, 1),
                                    ("shared", SHARED, 3, 2),
                                    ("span", SPAN, 5, 3)):
        jm, variables, flat, tm = tiny_models(seed, **conf)
        leaves = os.path.join(root, f"{name}.npz")
        np.savez(leaves, **flat)
        batch = _batch(bseed)
        bpath = os.path.join(root, f"{name}_batch.npz")
        np.savez(bpath, **batch)
        c["models"][name] = (jm, variables, batch, tm)
        c[name] = dict(conf=dict(TINY_CONF, **conf), leaves=leaves,
                       batch=bpath, feat_dim=FEAT_DIM, vocab=VOCAB)
    for name, src, extra in (
            ("pp2", "dense", dict(mode="grads")),
            ("pp2_tail", "dense", dict(mode="grads", tail=True)),
            ("pp2_shared", "shared", dict(mode="grads")),
            ("pp2_span", "span", dict(mode="grads")),
            ("pp2_span_sgd", "span", dict(mode="step", optim="sgd",
                                          lr=1.0)),
            ("pp2_sgd", "dense", dict(mode="step", optim="sgd", lr=1.0))):
        tasks[2].append(dict(c[src], kind="pp", name=name, dp=1, pp=2,
                             num_micro=4, **extra))
    tasks[4].append(dict(c["dense"], kind="pp", name="dp2pp2_adam", dp=2,
                         pp=2, num_micro=4, mode="step", optim="adam",
                         lr=ADAM_LR, tail=True))
    procs = {}
    for world, ts in tasks.items():
        work = os.path.join(root, f"world{world}")
        os.makedirs(work)
        with open(os.path.join(work, "tasks.json"), "w") as f:
            json.dump(ts, f)
        procs[world] = (spawn(work, world), work)
    try:
        ref = {}
        jm, variables, batch, _ = c["models"]["dense"]
        ref["seq"] = _jax_grads(jax_loss_fn(jm), variables, batch)
        devs = np.array(jax.devices()[:4]).reshape(2, 2)
        jmesh = JaxMesh(devs, ("data", "pipe"))
        with jax.sharding.set_mesh(jmesh):
            for tag, tail in (("pp", False), ("pp_tail", True)):
                ref[tag] = _jax_grads(jax_pp_loss_fn(
                    jm, jmesh, num_micro=4, tail_on_last_stage=tail),
                    variables, batch)
        jm, variables, batch, _ = c["models"]["shared"]
        ref["seq_shared"] = _jax_grads(jax_loss_fn(jm), variables, batch)
        jm, variables, batch, _ = c["models"]["span"]
        with jax.sharding.set_mesh(jmesh):
            ref["pp_span"] = _jax_grads(jax_pp_loss_fn(
                jm, jmesh, num_micro=4), variables, batch)
    finally:
        for world, (ps, work) in procs.items():
            wait(ps, work)
    c["ref"] = ref
    return c


def _load(job, name, rank, world=2):
    return torch.load(os.path.join(job["root"], f"world{world}",
                                   f"{name}.{rank}.pt"), weights_only=False)


def _assert_metrics(got: dict, want: dict,
                    keys=("loss", "loss_ctc", "loss_att", "acc")):
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)


def _assert_grads(got: dict, want: dict):
    g_max = max(float(w.abs().max()) for w in want.values())
    assert set(got) == set(want), set(want) ^ set(got)
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-7 * g_max, (k, err)


def _full_grads(job, name, model):
    """The whole model's gradients from the two pipe ranks: a layer's
    from the rank that holds it, the replicated ones from rank 0, which
    must equal rank 1's bit for bit."""
    ranks = [_load(job, name, r) for r in range(2)]
    out = {}
    for n in model.state_dict():
        holders = [r["grads"][n] for r in ranks if n in r["grads"]]
        if n.startswith("encoder.encoders.layer_"):
            assert len(holders) == 1, n
        else:
            assert len(holders) == 2 and torch.equal(*holders), n
        out[n] = holders[0]
    return out, ranks


@pytest.mark.parametrize("name,ref", [("pp2", "pp"), ("pp2", "seq"),
                                      ("pp2_tail", "pp_tail"),
                                      ("pp2_tail", "seq")])
def test_pp_loss_and_grads_match_jax(job, name, ref):
    tm = job["models"]["dense"][3]
    metrics, grads = job["ref"][ref]
    got, ranks = _full_grads(job, name, tm)
    # JAX's tail on the last stage averages the data shards' accuracies
    # (openeat_tpu/parallel/pipeline.py:235); the port's acc is the
    # global batch's, the sequential one's
    keys = ("loss", "loss_ctc", "loss_att") + (
        () if ref == "pp_tail" else ("acc",))
    for r in ranks:
        _assert_metrics(r["metrics"], metrics, keys)
    _assert_grads(got, flax_to_state_dict(grads, tm))


def test_pp_weight_shared_stack(job):
    """4 applications of 2 shared layers over 2 stages: each stage holds
    one physical layer, applied twice, whose gradient sums both."""
    tm = job["models"]["shared"][3]
    metrics, grads = job["ref"]["seq_shared"]
    got, ranks = _full_grads(job, "pp2_shared", tm)
    assert [r["held"] for r in ranks] == [["layer_0"], ["layer_1"]]
    _assert_metrics(ranks[0]["metrics"], metrics)
    _assert_grads(got, flax_to_state_dict(grads, tm))


def test_pp_shared_layer_spanning_both_stages(job):
    """The flagship's sharing (12 applications, 4 a layer) at pipe 2:
    layer 1 is applied on both stages, held by both, and its gradient,
    summed over the pipe group, is JAX's on every holder."""
    tm = job["models"]["span"][3]
    metrics, grads = job["ref"]["pp_span"]
    ranks = [_load(job, "pp2_span", r) for r in range(2)]
    assert [r["held"] for r in ranks] == [["layer_0", "layer_1"],
                                          ["layer_1", "layer_2"]]
    got = {}
    for n in tm.state_dict():
        holders = [r["grads"][n] for r in ranks if n in r["grads"]]
        shared = n.startswith("encoder.encoders.layer_1.")
        if shared or not n.startswith("encoder.encoders.layer_"):
            assert len(holders) == 2 and torch.equal(*holders), n
        else:
            assert len(holders) == 1, n
        got[n] = holders[0]
    for r in ranks:
        for key in ("loss", "loss_ctc", "loss_att", "acc"):
            np.testing.assert_allclose(r["metrics"][key], metrics[key],
                                       rtol=1e-6, err_msg=key)
        # the stage's K3 launches: its 6 applications a microbatch
        assert len(r["k3"]) == 6 * 4
    _assert_grads(got, flax_to_state_dict(grads, tm))


def test_pp_span_sgd_step_counts_the_shared_layer_once(job):
    tm = job["models"]["span"][3]
    metrics, grads = job["ref"]["pp_span"]
    want = flax_to_state_dict(grads, tm)
    norm = float(torch.sqrt(sum(g.double().square().sum()
                                for g in want.values())))
    scale = min(1.0, 5.0 / norm)
    got = _load(job, "pp2_span_sgd", 0)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], norm, rtol=1e-5)
    before = tm.state_dict()
    for k, g in want.items():
        step = float((scale * g).abs().max())
        err = float((got["params"][k] - (before[k] - scale * g))
                    .abs().max())
        assert err <= 1e-4 * step + 1e-7, (k, err, step)


def test_pp_ranks_hold_their_stage_only(job):
    tm = job["models"]["dense"][3]
    whole = sum(p.numel() * p.element_size() for p in tm.parameters())
    layer = sum(p.numel() * p.element_size()
                for p in tm.encoder.encoders.layer_0.parameters())
    for rank in range(2):
        got = _load(job, "pp2", rank)
        assert got["held"] == [f"layer_{rank}"]
        assert got["param_bytes"] == whole - layer
        # the stage's K3 launches: one a block a microbatch of 2 rows
        assert got["k3"] == [(2, 13 + 14, 64)] * 4


def test_pp_sgd_step_through_build_train_step(job):
    """One SGD step (lr 1, clip 5) with the pipelined loss: the JAX
    sequential gradient, clipped, is every update."""
    tm = job["models"]["dense"][3]
    metrics, grads = job["ref"]["seq"]
    want = flax_to_state_dict(grads, tm)
    norm = float(torch.sqrt(sum(g.double().square().sum()
                                for g in want.values())))
    scale = min(1.0, 5.0 / norm)
    got = _load(job, "pp2_sgd", 0)
    _assert_metrics(got["metrics"], metrics)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], norm, rtol=1e-5)
    before = tm.state_dict()
    for k, g in want.items():
        step = float((scale * g).abs().max())
        err = float((got["params"][k] - (before[k] - scale * g)).abs().max())
        assert err <= 1e-4 * step + 1e-7, (k, err, step)
    assert got["optimizer"]["param_groups"][0]["params"] == list(
        range(len(before)))


def test_pp_data2_pipe2_adam_step_equals_one_process(job):
    """data 2 x pipe 2, the tail on the last stage, one Adam step: the
    gathered weights and moments are the one-process step's."""
    _, _, batch, tm = job["models"]["dense"]
    model = tiny_models(0, **DENSE)[3]
    opt, schedule = build_optimizer(model, ADAM_LR, 1, "adam")
    state = TrainState(model, opt)
    metrics = build_train_step(schedule, 1, 5.0)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    got = _load(job, "dp2pp2_adam", 0, world=4)
    for key in ("loss", "loss_ctc", "loss_att", "acc", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][key], float(metrics[key]),
                                   rtol=1e-5, err_msg=key)
    names = [n for n, _ in model.named_parameters()]
    want = opt.state_dict()["state"]
    for i, n in enumerate(names):
        for key in ("exp_avg", "exp_avg_sq"):
            w, g = want[i][key], got["optimizer"]["state"][i][key]
            ref_max = float(w.abs().max())
            top = max(float(want[j][key].abs().max())
                      for j in range(len(names)))
            err = float((g - w).abs().max())
            assert err <= 1e-4 * ref_max + 1e-7 * top, (n, key, err)
        err = float((got["params"][n] - model.state_dict()[n]).abs().max())
        assert err <= 2 * ADAM_LR, (n, err)
    held = [_load(job, "dp2pp2_adam", r, world=4)["held"] for r in range(4)]
    assert held == [["layer_0"], ["layer_1"]] * 2


@pytest.mark.parametrize("tail", [False, True])
def test_pipe1_microbatches_equal_the_plain_loss(tail):
    """pipe = 1, four microbatches, no process group: the schedule alone
    against the plain forward and backward."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    models = [tiny_models(0, **DENSE)[3].train() for _ in range(2)]
    want = models[0](*batch.values())
    want["loss"].backward()
    loss_fn = pipeline.make_pp_loss_fn(models[1], _local(), 4, tail)
    got = loss_fn(models[1], batch)
    got["loss"].backward()
    _assert_metrics({k: v.item() for k, v in got.items()},
                    {k: v.item() for k, v in want.items()})
    _assert_grads({n: p.grad for n, p in models[1].named_parameters()},
                  {n: p.grad for n, p in models[0].named_parameters()})


@pytest.mark.parametrize("conf,mesh_kw,match", [
    (dict(moe_experts=4), {}, "mixture-of-experts"),
    (dict(static_chunk_size=4), {}, "full-context"),
    (dict(use_dynamic_chunk=True), {}, "full-context"),
    ({}, dict(tp=2), "without tensor sharding"),
    ({}, dict(pp=2), "apply_mesh"),
], ids=["moe", "chunk", "dynamic_chunk", "tp", "unstaged"])
def test_pp_refusals(conf, mesh_kw, match):
    tm = tiny_models(0, **DENSE, **conf)[3]
    mesh = _local()
    for k, v in mesh_kw.items():
        setattr(mesh, k, v)
    with pytest.raises(ValueError, match=match):
        pipeline.make_pp_loss_fn(tm, mesh, 2)


def test_pp_stage_layout_and_batch_refusals():
    assert stage_owner(2, 2, 2) == {0: (0,), 1: (1,)}
    assert stage_owner(12, 1, 4) == {i: (i // 3,) for i in range(12)}
    with pytest.raises(ValueError, match="not divisible"):
        stage_owner(3, 1, 2)
    # JAX's test layout: each layer's two applications on two stages
    assert stage_owner(2, 2, 4) == {0: (0, 1), 1: (2, 3)}
    # the flagship's 12 applications of 3 shared layers at pipe 2
    assert stage_owner(3, 4, 2) == {0: (0,), 1: (0, 1), 2: (1,)}
    tm = tiny_models(0, **DENSE)[3].train()
    loss_fn = pipeline.make_pp_loss_fn(tm, _local(), 3)
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    with pytest.raises(ValueError, match="microbatches"):
        loss_fn(tm, batch)
