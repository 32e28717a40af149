"""openeat_torch's mixture-of-experts FFN and MoE Conformer against the
JAX package, on the CPU, float32, dropout 0, inputs from numpy seeds.

Mirrors tests/test_moe.py. Tolerances: module outputs within atol 1e-5 /
rtol 1e-4 of JAX's and aux losses within rtol 1e-5 (summation order
only); the kept/dropped (token, expert) pairs equal to the numpy oracle
of tests/test_moe.py exactly; gradients within 1e-4 of their tensor's
max |grad| plus 1e-7 of the model's; after one Adam step every parameter
within 2 lr of JAX's (Adam divides by each gradient's own size, see
tests/test_torch_train_step.py); the recognize files byte-equal to the
JAX CLI's.
"""

import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import traverse_util

from openeat_tpu.bin import recognize as jax_recognize
from openeat_tpu.modules.feed_forward import \
    MoEPositionwiseFeedForward as JaxMoE
from openeat_tpu.parallel.train_step import TrainState as JaxTrainState
from openeat_tpu.parallel.train_step import \
    build_train_step as jax_build_train_step
from openeat_tpu.utils import checkpoint as jax_ckpt
from openeat_tpu.utils.checkpoint import _flatten
from openeat_tpu.utils.optim import build_optimizer as jax_build_optimizer
from openeat_tpu.utils.quantize import QTensor, quantize_params
from openeat_torch.bin import recognize
from openeat_torch.modules.feed_forward import MoEPositionwiseFeedForward
from openeat_torch.modules.layers import Dense
from openeat_torch.parallel.train_step import TrainState, build_train_step
from openeat_torch.utils.optim import build_optimizer
from openeat_torch.utils.param_bridge import flax_to_state_dict
from openeat_torch.utils.quantize import quantize_model
from tests._torch_parity import FEAT_DIM, TINY_CONF, VOCAB, tiny_models, \
    to_np
from tests.make_tiny_data import build as build_tiny
from tests.test_moe import _oracle

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-4)
MOE = dict(moe_experts=4, moe_top_k=2, dropout_rate=0.0)


def _modules(e=4, k=2, cap=4.0, d=8, h=16, seed=3, shape=(2, 6, 8)):
    """The JAX module with its params (drawn by init, biases drawn from a
    seed so none is zero) and the port's module with the same weights."""
    jmod = JaxMoE(d_model=d, hidden_units=h, num_experts=e, top_k=k,
                  capacity_factor=cap, dropout_rate=0.0,
                  activation=jax.nn.relu)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seed), jnp.zeros(shape))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x if path[-1].key in ("kernel", "w_in", "w_out")
        else jnp.asarray(0.1 * rng.standard_normal(x.shape), jnp.float32),
        params)
    tmod = MoEPositionwiseFeedForward(d, h, e, k, cap, F.relu)
    tmod.load_state_dict(flax_to_state_dict(_flatten(params), tmod))
    return jmod, params, tmod


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_apply(jmod, params, x, pad_mask=None):
    y, var = jax.jit(partial(jmod.apply, mutable=["intermediates"]))(
        params, jnp.asarray(x),
        pad_mask=None if pad_mask is None else jnp.asarray(pad_mask))
    return np.asarray(y), float(jax.tree.leaves(var["intermediates"])[0])


@pytest.mark.parametrize("e,k,cap,shape", [
    (4, 2, 8.0, (2, 6, 8)),      # ample capacity: nothing dropped
    (3, 1, 8.0, (1, 9, 8)),      # top-1
    (2, 1, 0.25, (1, 16, 8)),    # saturated: tokens dropped
    (4, 2, 0.6, (3, 7, 8)),      # top-2 with drops
], ids=["no_drops", "top1", "drops_top1", "drops_top2"])
def test_moe_ffn_matches_jax_and_the_oracle(e, k, cap, shape):
    jmod, params, tmod = _modules(e, k, cap, shape=shape)
    x = _x(shape)
    j_y, j_aux = _jax_apply(jmod, params, x)
    with torch.no_grad():
        y, aux = tmod(torch.from_numpy(x))
        keep = tmod.route(torch.from_numpy(x))[2]
    np.testing.assert_allclose(to_np(y), j_y, **TOL)
    np.testing.assert_allclose(float(aux), j_aux, rtol=1e-5)
    y_ref, aux_ref, keep_ref = _oracle(params, x, e, k, cap)
    np.testing.assert_array_equal(to_np(keep), keep_ref > 0)
    np.testing.assert_allclose(float(aux), aux_ref, rtol=1e-5)
    dropped = keep_ref.sum(-1) == 0
    if cap < 1:
        assert dropped.any(), "test premise: tokens over capacity"
        np.testing.assert_array_equal(to_np(y).reshape(-1, 8)[dropped], 0.0)
    else:
        assert not dropped.any(), "test premise: no drops"


def test_moe_padding_invariance_matches_jax():
    jmod, params, tmod = _modules(cap=8.0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 8)).astype(np.float32)
    junk = (10 * rng.standard_normal((2, 4, 8))).astype(np.float32)
    x_pad = np.concatenate([x, junk], axis=1)
    mask = np.broadcast_to(np.arange(10) < 6, (2, 10)).copy()
    j_y, j_aux = _jax_apply(jmod, params, x_pad, mask)
    with torch.no_grad():
        ref, ref_aux = tmod(torch.from_numpy(x))
        y, aux = tmod(torch.from_numpy(x_pad), torch.from_numpy(mask))
        y3, _ = tmod(torch.from_numpy(x_pad), torch.from_numpy(mask)[:, None])
    np.testing.assert_allclose(to_np(y), j_y, **TOL)
    np.testing.assert_allclose(float(aux), j_aux, rtol=1e-5)
    np.testing.assert_allclose(to_np(y[:, :6]), to_np(ref), atol=1e-6)
    np.testing.assert_array_equal(to_np(y[:, 6:]), 0.0)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-6)
    np.testing.assert_array_equal(to_np(y3), to_np(y))


def test_moe_aux_and_output_gradients_match_jax():
    """d(sum(y * w) + aux)/d(every parameter and x)."""
    jmod, params, tmod = _modules(e=4, k=2, cap=0.6, shape=(2, 7, 8))
    x = _x((2, 7, 8), seed=4)
    w = _x((2, 7, 8), seed=5)
    mask = np.ones((2, 7), bool)
    mask[1, 5:] = False

    def f(p, xx):
        y, var = jmod.apply(p, xx, pad_mask=jnp.asarray(mask),
                            mutable=["intermediates"])
        aux = jax.tree.leaves(var["intermediates"])[0]
        return jnp.sum(y * w) + aux

    j_gp, j_gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tmod(xt, torch.from_numpy(mask))
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    want = flax_to_state_dict(_flatten(j_gp), tmod)
    g_max = max(float(g.abs().max()) for g in want.values())
    for name, p in tmod.named_parameters():
        ref = want[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max() + 1e-7 * g_max, (name, err)
    np.testing.assert_allclose(to_np(xt.grad), np.asarray(j_gx), **TOL)


def _model_batch(seed=1, b=3, t=57):
    rng = np.random.default_rng(seed)
    ys = rng.integers(1, VOCAB - 1, (b, 8)).astype(np.int32)
    ys_lens = np.array([8, 5, 3][:b], np.int32)
    for i, n in enumerate(ys_lens):
        ys[i, n:] = -1
    return {"features": rng.standard_normal((b, t, FEAT_DIM)).astype(
                np.float32),
            "features_length": np.array([t, t - 16, 31][:b], np.int32),
            "targets": ys, "targets_length": ys_lens}


def _tb(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def test_moe_model_forward_and_encoder_layer_match_jax():
    jm, variables, _, tm = tiny_models(0, **MOE, moe_capacity_factor=0.8)
    batch = _model_batch()
    metrics, var = jax.jit(partial(jm.apply, mutable=["intermediates"]))(
        variables, *map(jnp.asarray, batch.values()))
    aux = [np.asarray(a) for a in jax.tree.leaves(var["intermediates"])]
    assert len(aux) == 2
    tm.train()
    got = tm(*_tb(batch).values())
    for key in ("loss", "loss_ctc", "loss_att", "acc"):
        np.testing.assert_allclose(float(got[key]), float(metrics[key]),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(float(got["moe_aux"]), np.mean(aux),
                               rtol=1e-5)
    # one encoder layer with its padding mask
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    mask = np.ones((2, 1, 9), bool)
    mask[1, 0, 6:] = False
    pos = rng.standard_normal((1, 9, 64)).astype(np.float32)

    def layer(m, *a):
        return m.encoder.encoders.layers[1](*a)

    j = jax.jit(partial(jm.apply, method=layer))(
        variables, *map(jnp.asarray, (x, mask, pos)))
    tm.eval()
    with torch.no_grad():
        aux_t = []
        t = tm.encoder.encoders.layer_1(
            *map(torch.from_numpy, (x, mask, pos)), moe_aux=aux_t)
    np.testing.assert_allclose(to_np(t), np.asarray(j), **TOL)
    assert len(aux_t) == 1


def test_moe_train_step_matches_jax_make_loss_fn():
    """One Adam step of the port's train step against JAX's
    build_train_step (make_loss_fn's loss): loss (aux included at
    moe_aux_weight), moe_aux, grad_norm and every parameter."""
    jm, variables, _, tm = tiny_models(0, **MOE, moe_capacity_factor=0.8,
                                       moe_aux_weight=0.5)
    batch = _model_batch(seed=3)
    lr = 1e-3
    tx, _ = jax_build_optimizer(lr, 3, "adam", variables)
    j_state = JaxTrainState(variables, tx.init(variables),
                            jnp.zeros((), jnp.int32))
    j_state, j_metrics = jax.jit(jax_build_train_step(jm, tx, 1, 5.0,
                                                      donate=False))(
        j_state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    opt, schedule = build_optimizer(tm, lr, 3, "adam")
    state = TrainState(tm, opt)
    metrics = build_train_step(schedule, 1, 5.0)(state, _tb(batch), None)
    for key in ("loss", "moe_aux", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(j_metrics[key]), rtol=1e-4,
                                   err_msg=key)
    # the aux term is in the loss at moe_aux_weight
    np.testing.assert_allclose(
        float(metrics["loss"]) - 0.5 * float(metrics["moe_aux"]),
        float(j_metrics["loss"]) - 0.5 * float(j_metrics["moe_aux"]),
        rtol=1e-5)
    want = flax_to_state_dict(_flatten(j_state.params), tm)
    for name, p in tm.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name].numpy()).max()
        assert diff <= 2 * lr, (name, diff)


STREAM_MOE = dict(d_model=32, attention_heads=2, linear_units=64,
                  cnn_module_kernel=5, causal=True, static_chunk_size=4,
                  num_left_chunks=2, moe_capacity_factor=0.7, **MOE)


def test_moe_layer_forward_chunk_matches_jax():
    """An MoE layer's streaming step routes each stream's chunk with no
    pad mask and the chunk's own capacity, as JAX's step does for one
    stream."""
    jm, variables, _, tm = tiny_models(0, **STREAM_MOE)
    rng = np.random.default_rng(4)
    b, tc, lc, d, h = 2, 4, 8, 32, 2
    x = rng.standard_normal((b, tc, d)).astype(np.float32)
    kc = rng.standard_normal((b, lc, h, d // h)).astype(np.float32)
    vc = rng.standard_normal((b, lc, h, d // h)).astype(np.float32)
    kv_mask = np.ones((b, 1, lc + tc), bool)
    kv_mask[0, 0, :5] = False
    cnn = rng.standard_normal((b, 4, d)).astype(np.float32)
    pos = rng.standard_normal((b, lc + tc, d)).astype(np.float32)

    def layer(m, *a):
        return m.encoder.encoders.layers[1].forward_chunk(*a)

    args = (x, kc, vc, kv_mask, cnn, pos)
    step = jax.jit(partial(jm.apply, method=layer))
    # the JAX runtimes vmap a one-stream step over the slots: each row
    # is routed on its own
    rows = [step(variables, *(jnp.asarray(a[i:i + 1]) for a in args))
            for i in range(b)]
    with torch.no_grad():
        t = tm.encoder.encoders.layer_1.forward_chunk(
            *map(torch.from_numpy, args))
    for n, got in enumerate(t):
        want = np.concatenate([to_np(r[n]) for r in rows])
        np.testing.assert_allclose(to_np(got), want, **TOL)


def test_bridge_leaves_and_int8_leave_the_moe_banks_in_float():
    """The MoE leaves land as they are (the router transposed, as every
    Dense), and int8 quantizes the same Dense weights as JAX's
    quantize_params: neither the router (E x D = 256 weights, below
    min_size) nor the 3-D banks."""
    _, variables, flat, tm = tiny_models(0, **MOE)
    state = tm.state_dict()
    lay = "encoder.encoders.layer_0.feed_forward"
    for leaf in ("w_in", "b_in", "w_out", "b_out"):
        np.testing.assert_array_equal(
            to_np(state[f"{lay}.{leaf}"]),
            flat[f"params/{lay.replace('.', '/')}/{leaf}"])
    np.testing.assert_array_equal(
        to_np(state[f"{lay}.router.weight"]),
        flat[f"params/{lay.replace('.', '/')}/router/kernel"].T)
    qv = quantize_params(variables, min_size=1024)
    jq = {".".join(p[1:-1]) for p, leaf in
          traverse_util.flatten_dict(qv).items() if isinstance(leaf, QTensor)}
    quantize_model(tm, min_size=1024)
    got = {n for n, m in tm.named_modules()
           if isinstance(m, Dense) and m.q is not None}
    assert got == jq and got
    assert not any("router" in n for n in got)
    assert all(getattr(tm.get_submodule(lay), p).dtype == torch.float32
               for p in ("w_in", "w_out"))


def test_recognize_moe_checkpoint_writes_the_jax_cli_files(tmp_path):
    """attention_rescoring with timestamps on a tiny MoE checkpoint: the
    port's result and timestamp files equal the JAX CLI's."""
    data = build_tiny(str(tmp_path), n_utts=5, seed=9, max_dur=1.4)
    conf = dict(TINY_CONF, **MOE, moe_capacity_factor=0.9)
    _, variables, flat, _ = tiny_models(1, **conf)
    npz = str(tmp_path / "moe.npz")
    np.savez(npz, **flat)
    jax_ckpt.save_checkpoint(str(tmp_path), "jax_moe", variables)
    cfg = str(tmp_path / "moe.json")
    with open(cfg, "w") as f:
        json.dump({"model_conf": conf, "vocab_size": VOCAB}, f)
    outs = []
    for name, main, ckpt, extra in (
            ("port", recognize.main, npz, ["--device", "cpu"]),
            ("jax", jax_recognize.main, str(tmp_path / "jax_moe"), [])):
        paths = [str(tmp_path / f"{name}.{ext}") for ext in ("txt", "jsonl")]
        main(["--config", cfg, "--checkpoint", ckpt, "--test_data",
              data["manifest"], "--dict", data["dict"], "--result_file",
              paths[0], "--timestamp_file", paths[1], "--mode",
              "attention_rescoring", "--batch_size", "4", "--beam_size", "3",
              "--reverse_weight", "0.3"] + extra)
        outs.append([open(p, encoding="utf-8").read() for p in paths])
    assert outs[0] == outs[1]
    assert len(outs[0][0].splitlines()) == 5


def test_stream_recognize_moe_checkpoint_writes_the_jax_files(tmp_path):
    """An MoE checkpoint streams: stream_recognize --slots 2 with
    rescoring finals writes the JAX CLI's result and timestamp files
    (each chunk routed with its own capacity in both)."""
    from openeat_tpu.bin import stream_recognize as jax_stream_recognize
    from openeat_torch.bin import stream_recognize
    conf = dict(TINY_CONF, **STREAM_MOE, moe_aux_weight=0.01)
    data = build_tiny(str(tmp_path), n_utts=4, seed=3, min_dur=0.5,
                      max_dur=1.2)
    _, variables, flat, _ = tiny_models(5, **STREAM_MOE)
    npz = str(tmp_path / "moe.npz")
    np.savez(npz, **flat)
    jax_ckpt.save_checkpoint(str(tmp_path), "jax_moe", variables)
    cfg = str(tmp_path / "moe.json")
    with open(cfg, "w") as f:
        json.dump({"model_conf": conf, "vocab_size": VOCAB,
                   "collate_conf": {"normalization": True}}, f)
    outs = []
    for name, main, ckpt, extra in (
            ("port", stream_recognize.main, npz, ["--device", "cpu"]),
            ("jax", jax_stream_recognize.main, str(tmp_path / "jax_moe"),
             [])):
        paths = [str(tmp_path / f"s_{name}.{ext}") for ext in ("txt",
                                                                "jsonl")]
        main(["--config", cfg, "--checkpoint", ckpt, "--test_data",
              data["manifest"], "--dict", data["dict"], "--result_file",
              paths[0], "--timestamp_file", paths[1], "--chunk_size", "4",
              "--num_left_chunks", "2", "--piece_ms", "150",
              "--enc_capacity", "64", "--slots", "2", "--final_mode",
              "attention_rescoring", "--reverse_weight", "0.3",
              "--beam_size", "3"] + extra)
        outs.append([open(p, encoding="utf-8").read() for p in paths])
    assert outs[0] == outs[1]
    assert len(outs[0][0].splitlines()) == 4


def test_moe_recipe_config_builds():
    """examples/aishell/conf/train_conformer_moe.yaml builds at full
    width: 12 blocks, each with a top-2 mixture of 4 experts in its main
    FFN and a dense macaron FFN, and the JAX defaults for the MoE keys
    it leaves out."""
    from openeat_torch.config import load_config
    from openeat_torch.models.asr_model import build_asr_model
    cfg = load_config("examples/aishell/conf/train_conformer_moe.yaml")
    model = build_asr_model(cfg["model_conf"], 80, 4233)
    moe = [m for m in model.modules()
           if isinstance(m, MoEPositionwiseFeedForward)]
    assert len(moe) == 12
    assert all(m.num_experts == 4 and m.top_k == 2
               and m.capacity_factor == 1.25 for m in moe)
    assert model.moe_aux_weight == 0.01
    layer = model.encoder.encoders.layer_0
    assert tuple(layer.feed_forward.w_in.shape) == (4, 256, 1024)
    assert not isinstance(layer.feed_forward_macaron,
                          MoEPositionwiseFeedForward)
    conf = {k: v for k, v in cfg["model_conf"].items()
            if k not in ("moe_top_k", "moe_capacity_factor",
                         "moe_aux_weight")}
    defaults = build_asr_model(conf, 80, 4233)
    ff = defaults.encoder.encoders.layer_0.feed_forward
    assert (ff.top_k, ff.capacity_factor, defaults.moe_aux_weight) == \
        (2, 1.25, 0.01)
