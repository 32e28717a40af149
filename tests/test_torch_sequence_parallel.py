"""openeat_torch's sequence parallelism (`sequence_sharding`: the encoder
block stack's time axis over the model group) against JAX's and the
unsharded port, on the CPU; and the data group's one chunk draw a step.

A gloo job of two ranks (tests/_torch_dist_worker.py) runs every
port-side check while this process computes the JAX references on the
virtual CPU devices of tests/conftest.py: the JAX encoder and train
step of the same weights with sequence_sharding under
jax.sharding.set_mesh on a (1, 2) mesh. Float32, dropout 0 unless
stated, weights and batches from numpy seeds (tests/_torch_parity.py's
tiny Conformer, d = 64, kernel 15). Tolerances are
tests/test_torch_parallel.py's: one SGD step (lr 1, clip 5) at tp = 2,
losses and grad_norm within 1e-5 relative, every update within 1e-4 of
its tensor's largest update plus 1e-7; the encoder output within 1e-4
of its largest plus 1e-6.

Cases: the flagship layout (heads and FFN sharded over the model
group, the symmetric conv's halo of 7 frames a side); replicated
attention and FFN (1 head, 127 hidden units) with the causal conv's
left-only halo of 14; a chunk-masked model; the MoE Conformer; an odd
T' that runs unsharded; adapters in every block (replicated over the
model group, run on each rank's frames, their gradients summed over
the group with the other replicated parameters'). K3's input on each rank is its shard plus the
halo: [B, T'/2 + 14, 64]. The halo exchange's value and gradient equal
autograd's through the unsharded F.pad for both conv layouts.

bin.train: --tp 2 with sequence_sharding trains what --tp 2 without it
trains (dropout 0.1: the shards draw the whole masks), and at --dp 2
with use_dynamic_chunk both data ranks draw one chunk size a step while
their dropout masks differ.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.models.asr_model import build_asr_model as jax_build
from openeat_tpu.parallel import mesh as jax_mesh
from openeat_tpu.parallel.train_step import TrainState as JaxTrainState
from openeat_tpu.parallel.train_step import \
    build_train_step as jax_build_train_step
from openeat_tpu.parallel.train_step import shard_and_jit
from openeat_tpu.utils.checkpoint import _flatten
from openeat_tpu.utils.optim import build_optimizer as jax_build_optimizer
from openeat_torch.parallel.train_step import TrainState, build_train_step
from openeat_torch.utils.optim import build_optimizer
from openeat_torch.utils.param_bridge import flax_to_state_dict
from tests._torch_jobs import spawn, wait
from tests._torch_parity import FEAT_DIM, TINY_CONF, VOCAB, tiny_models
from tests.make_tiny_data import build as build_tiny

torch.set_num_threads(1)
SP = dict(dropout_rate=0.0, sequence_sharding=True)
# (conf, model seed, batch seed, frames): T' = ((T - 1) // 2 - 1) // 2
CASES = {
    "sp": (SP, 0, 1, 61),                                    # T' = 14
    "sp_replicated_causal": (dict(SP, attention_heads=1, linear_units=127,
                                  causal=True), 2, 3, 117),  # T' = 28
    "sp_chunk": (dict(SP, static_chunk_size=4, num_left_chunks=1), 4, 5,
                 61),
    "sp_moe": (dict(SP, moe_experts=4, moe_top_k=2,
                    moe_capacity_factor=0.5), 6, 7, 61),
    "sp_odd": (SP, 0, 1, 57),                                # T' = 13
    "sp_adapter": (dict(SP, encoder_use_adapter=True,
                        decoder_use_adapter=True, down_size=16), 8, 9, 61),
}
HALO = {"sp": 7, "sp_replicated_causal": 14, "sp_chunk": 7, "sp_moe": 7,
        "sp_adapter": 7}


def _batch(seed, t, b=4):
    rng = np.random.default_rng(seed)
    ys_lens = np.array([8, 5, 3, 6][:b], np.int32)
    ys = rng.integers(1, VOCAB - 1, (b, 8)).astype(np.int32)
    for i, n in enumerate(ys_lens):
        ys[i, n:] = -1
    return {"features": rng.standard_normal((b, t, FEAT_DIM)).astype(
                np.float32),
            "features_length": np.array([t, t - 9, t - 20, t - 3][:b],
                                        np.int32),
            "targets": ys, "targets_length": ys_lens}


def _jax_sp(conf, variables, batch):
    """JAX's encoder output and one SGD step with sequence_sharding under
    set_mesh on a (1, 2) mesh (the TP rules shard the parameters)."""
    jm = jax_build(dict(TINY_CONF, **conf), FEAT_DIM, VOCAB)
    tx, _ = jax_build_optimizer(1.0, 1, "sgd", variables)
    state = JaxTrainState(variables, tx.init(variables),
                          jnp.zeros((), jnp.int32))
    m = jax_mesh.make_mesh(1, 2)
    shardings = JaxTrainState(
        jax_mesh.param_shardings(state.params, m),
        jax.tree.map(lambda _: jax_mesh.replicated(m), state.opt_state),
        jax_mesh.replicated(m))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    bshard = jax_mesh.batch_shardings(jb, m)
    with jax.sharding.set_mesh(m):
        enc = jax.jit(lambda v, x, n: jm.apply(v, x, n, method=jm.encode))(
            variables, jb["features"], jb["features_length"])[0]
        step = shard_and_jit(jax_build_train_step(jm, tx, 1, 5.0,
                                                  donate=False),
                             m, shardings, bshard, donate_state=False)
        new, metrics = step(jax.device_put(state, shardings),
                            jax.device_put(jb, bshard),
                            jax.random.PRNGKey(0))
    return (np.asarray(enc), {k: float(v) for k, v in metrics.items()},
            _flatten(jax.device_get(new.params)))


def _port_step(tm, batch):
    """One SGD step of the unsharded port (a copy of tm)."""
    model = copy.deepcopy(tm)
    opt, schedule = build_optimizer(model, 1.0, 1, "sgd")
    metrics = build_train_step(schedule, 1, 5.0)(
        TrainState(model, opt),
        {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.clone() for k, v in model.state_dict().items()})


def _train_argv(c, name, conf, extra):
    cfg = os.path.join(c["root"], f"{name}.json")
    with open(cfg, "w") as f:
        json.dump({"model_conf": conf,
                   "dataset_conf": {"batch_type": "dynamic",
                                    "max_frames_in_batch": 400},
                   "optim_conf": {"lr": 0.002}, "warmup_steps": 2,
                   "log_interval": 1, "seed": 11}, f)
    data = c["data"]
    return ["--config", cfg, "--train_data", data["manifest"], "--cv_data",
            data["manifest"], "--dict", data["dict"], "--exp_dir",
            os.path.join(c["root"], name), "--device", "cpu",
            "--num_workers", "1", "--max_epoch", "1", *extra]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_sp"))
    c = {"root": root, "cases": {}}
    c["data"] = build_tiny(os.path.join(root, "data"), n_utts=8, seed=6,
                           max_dur=1.4)
    tasks = []
    for name, (conf, seed, bseed, t) in CASES.items():
        _, variables, flat, tm = tiny_models(seed, **conf)
        leaves = os.path.join(root, f"{name}.npz")
        np.savez(leaves, **flat)
        batch = _batch(bseed, t)
        bpath = os.path.join(root, f"{name}_batch.npz")
        np.savez(bpath, **batch)
        c["cases"][name] = (conf, variables, batch, tm)
        tasks.append({"kind": "step", "name": name, "dp": 1, "tp": 2,
                      "conf": dict(TINY_CONF, **conf), "leaves": leaves,
                      "batch": bpath, "feat_dim": FEAT_DIM, "vocab": VOCAB,
                      "lr": 1.0, "encode": True})
    tasks.append({"kind": "halo", "name": "halo",
                  "pads": [[7, 7], [14, 0]]})
    drop = dict(TINY_CONF, dropout_rate=0.1)
    for name, conf, extra in (
            ("train_tp", drop, ["--tp", "2"]),
            ("train_sp", dict(drop, sequence_sharding=True), ["--tp", "2"]),
            ("train_chunk", dict(drop, use_dynamic_chunk=True),
             ["--dp", "2"])):
        tasks.append({"kind": "cli", "cli": "train", "name": name,
                      "draws": name == "train_chunk",
                      "argv": _train_argv(c, name, conf, extra)})
    with open(os.path.join(root, "tasks.json"), "w") as f:
        json.dump(tasks, f)
    procs = spawn(root, 2)
    try:
        conf, variables, batch, _ = c["cases"]["sp"]
        c["jax"] = _jax_sp(conf, variables, batch)
        c["port"] = {name: _port_step(tm, batch)
                     for name, (_, _, batch, tm) in c["cases"].items()}
    finally:
        wait(procs, root)
    return c


def _load(job, name, rank=None):
    tag = name if rank is None else f"{name}.{rank}"
    return torch.load(os.path.join(job["root"], f"{tag}.pt"),
                      weights_only=False)


def _assert_step(got, metrics, params, before):
    for key in ("loss", "loss_ctc", "loss_att", "acc", "grad_norm",
                "moe_aux"):
        if key in metrics:
            np.testing.assert_allclose(got["metrics"][key], metrics[key],
                                       rtol=1e-5, err_msg=key)
    for k, w in params.items():
        step = (w - before[k]).abs().max()
        err = (got["params"][k] - w).abs().max()
        assert err <= 1e-4 * step + 1e-7, (k, float(err), float(step))


def _assert_encoder(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * scale + 1e-6)


def test_sp_matches_jax_under_set_mesh(job):
    """The flagship layout: the encoder output and one step equal JAX's
    under set_mesh, whose seq_shard shards the same activations."""
    enc, metrics, params = job["jax"]
    tm = job["cases"]["sp"][3]
    got = _load(job, "sp")
    _assert_encoder(got["encoder_out"], enc)
    _assert_step(got, metrics, flax_to_state_dict(params, tm),
                 tm.state_dict())


@pytest.mark.parametrize("name", list(CASES))
def test_sp_step_matches_the_unsharded_port(job, name):
    tm = job["cases"][name][3]
    metrics, params = job["port"][name]
    got = _load(job, name)
    _assert_step(got, metrics, params, tm.state_dict())
    batch = job["cases"][name][2]
    with torch.no_grad():
        want = tm.encode(torch.from_numpy(batch["features"]),
                         torch.from_numpy(batch["features_length"]).long())
    _assert_encoder(got["encoder_out"], want[0].numpy())


@pytest.mark.parametrize("name", list(CASES))
def test_k3_runs_on_the_shard_plus_its_halo(job, name):
    """Every K3 input of the step is [B, T'/2 + 14, 64] on both ranks:
    the shard with (K-1)/2 frames a side, or K-1 on the left for the
    causal conv; an odd T' runs unsharded, [B, T' + 14, 64]."""
    t = CASES[name][3]
    t_sub = ((t - 1) // 2 - 1) // 2
    rows = t_sub // 2 if name != "sp_odd" else t_sub
    blocks = TINY_CONF["encoder_num_blocks"]
    for rank in range(2):
        shapes = _load(job, name, rank)["k3"]
        assert shapes == [(4, rows + 14, 64)] * blocks, (rank, shapes)
    if name != "sp_odd":
        assert rows >= HALO[name]


def test_halo_exchange_equals_the_unsharded_pad(job):
    for rank in range(2):
        got = _load(job, "halo", rank)
        for pads, (y_err, g_err, shape) in got.items():
            left, right = map(int, pads.split(","))
            assert shape == (3, 16 + left + right, 5)
            assert y_err == 0.0 and g_err < 1e-5, (rank, pads, got)


def test_train_cli_sp_trains_what_tp_trains(job):
    root = job["root"]
    tp_, sp = (torch.load(os.path.join(root, n, "epoch_1.pt"),
                          weights_only=True)
               for n in ("train_tp", "train_sp"))
    for k, w in tp_.items():
        err = float((sp[k] - w).abs().max())
        # Adam turns the attention key biases' rounding noise into steps
        # of up to lr
        bound = 2 * 0.002 * 4 if k.endswith("linear_k.bias") else \
            1e-4 + 1e-4 * float(w.abs().max())
        assert err <= bound, (k, err)
    shapes = {n: _load(job, n, 0)["k3"] for n in ("train_tp", "train_sp")}
    assert shapes["train_sp"] != shapes["train_tp"], shapes
    with open(os.path.join(root, "train_sp", "metrics.jsonl")) as f:
        sp_steps = [json.loads(x) for x in f]
    with open(os.path.join(root, "train_tp", "metrics.jsonl")) as f:
        tp_steps = [json.loads(x) for x in f]
    for a, b in zip(sp_steps, tp_steps):
        if "loss" in a:
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)


def test_dp_ranks_draw_one_chunk_size_a_step(job):
    draws = [_load(job, "train_chunk", r)["draws"] for r in range(2)]
    assert len(draws[0]) == len(draws[1]) >= 2
    chunks = [[d["chunk"] for d in r] for r in draws]
    assert chunks[0] == chunks[1], chunks
    assert all(a["next"] != b["next"] for a, b in zip(*draws))
