"""openeat_torch's data, tensor and expert parallelism against the JAX
mesh, on the CPU.

One job of two gloo ranks (tests/_torch_dist_worker.py, started as
torchrun would start it) runs every port-side check, while this process
computes the JAX references on the 8 virtual CPU devices that
tests/conftest.py provides. Float32, dropout 0, weights and batches from
numpy seeds (tests/_torch_parity.py: d=64, 4 heads, vocab 40, so the
embedding and the output layers shard too). Tolerances:
- one SGD step (lr 1, clip 5) at dp = 2 against the JAX step on a
  (2, 1) mesh, at tp = 2 against (1, 2), and of the MoE Conformer at
  dp = 2 and tp = 2 (experts sharded) against (2, 2), each on the same
  global batch (padded to a multiple of 2 as the JAX feeder pads it for
  dp = 2; the tp = 2 rank takes it whole): loss, acc, moe_aux and
  grad_norm within 1e-5 relative; every parameter's update within 1e-4
  of its tensor's largest update plus 1e-7 (summation order over the
  ranks);
- the MoE batch saturates its experts, and a rank that used its own
  tokens' capacity (the naive port) would keep other tokens;
- a rank's features from the dp = 2 training feeder equal its rows of
  the single-process feeder's (dither, spec-sub, SpecAugment on): 0;
- recognize --dp 2: result and timestamp files byte-equal to --dp 1's
  (four modes and n-gram fusion) and to the JAX CLI's --dp 2;
- train_lm --dp 2 and --tp 2 from the same weights as a JAX train_lm
  --dp 2 --tp 2 run (batches of 2 rows, so neither pads): epoch_1 cv
  loss and accuracy within 1e-4, every weight within 1e-4 plus 1e-3 of
  its tensor's largest change after four Adam steps, the attention key
  biases within 2 lr a step (their gradient is rounding noise, which
  Adam scales up to lr);
- epoch_1.pt written at --tp 2 holds each rank's shard at its place and
  loads into the unsharded model; a checkpoint of the unsharded model
  shards and gathers back bit-equal;
- --multihost: the loader's per-node batches equal the JAX loader's
  (shard_id, num_shards), and a two-node train run takes half the
  steps.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from openeat_tpu.bin import recognize as jax_recognize
from openeat_tpu.bin import train_lm as jax_train_lm
from openeat_tpu.dataset.dataset import AudioDataset as JaxAudioDataset
from openeat_tpu.dataset.dataset import PrefetchLoader as JaxPrefetchLoader
from openeat_tpu.dataset.text import load_dict as jax_load_dict
from openeat_tpu.models.language_model import \
    build_language_model as build_jax_lm
from openeat_tpu.ops.frontend import FrontendConfig as JaxFrontendConfig
from openeat_tpu.parallel import mesh as jax_mesh
from openeat_tpu.parallel.train_step import TrainState as JaxTrainState
from openeat_tpu.parallel.train_step import \
    build_train_step as jax_build_train_step
from openeat_tpu.parallel.train_step import shard_and_jit
from openeat_tpu.pipeline import DeviceFeeder as JaxDeviceFeeder
from openeat_tpu.utils import checkpoint as jax_ckpt
from openeat_tpu.utils.checkpoint import _flatten
from openeat_tpu.utils.optim import build_optimizer as jax_build_optimizer
from openeat_torch.bin import recognize, train
from openeat_torch.dataset.dataset import AudioDataset, PrefetchLoader
from openeat_torch.dataset.text import load_dict
from openeat_torch.models.asr_model import build_asr_model
from openeat_torch.models.language_model import build_language_model
from openeat_torch.modules.feed_forward import MoEPositionwiseFeedForward
from openeat_torch.parallel import mesh
from openeat_torch.utils.param_bridge import flax_to_state_dict
from tests._torch_jobs import spawn, wait
from tests._torch_parity import FEAT_DIM, TINY_CONF, VOCAB, _draw, \
    tiny_models
from tests.make_tiny_data import build as build_tiny
from tests.test_torch_recognize import _write_arpa

torch.set_num_threads(1)
DENSE = dict(dropout_rate=0.0)
MOE = dict(dropout_rate=0.0, moe_experts=4, moe_top_k=2,
           moe_capacity_factor=0.5)
LM_CONF = dict(d_model=32, attention_heads=2, linear_units=64, num_blocks=2,
               dropout_rate=0.0, activation="relu", lsm_weight=0.1,
               compute_dtype="float32")
MODES = ["ctc_greedy_search", "ctc_prefix_beam_search", "attention",
         "attention_rescoring"]
JAX_MODES = ["attention_rescoring"]


def _batch(seed, b=3, t=57):
    """b rows; with b = 3 the dp = 2 batch pads to 4 rows."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(1, VOCAB - 1, (b, 8)).astype(np.int32)
    ys_lens = np.array([8, 5, 3, 6][:b], np.int32)
    for i, n in enumerate(ys_lens):
        ys[i, n:] = -1
    return {"features": rng.standard_normal((b, t, FEAT_DIM)).astype(
                np.float32),
            "features_length": np.array([t, t - 16, 31, t - 5][:b],
                                        np.int32),
            "targets": ys, "targets_length": ys_lens}


def _jax_step(conf, variables, batch, data, model):
    """One SGD step of the JAX model on the (data, model) mesh."""
    from openeat_tpu.models.asr_model import build_asr_model as jax_build
    jm = jax_build(dict(TINY_CONF, **conf), FEAT_DIM, VOCAB)
    tx, _ = jax_build_optimizer(1.0, 1, "sgd", variables)
    state = JaxTrainState(variables, tx.init(variables),
                          jnp.zeros((), jnp.int32))
    m = jax_mesh.make_mesh(data, model)
    shardings = JaxTrainState(
        jax_mesh.param_shardings(state.params, m),
        jax.tree.map(lambda _: jax_mesh.replicated(m), state.opt_state),
        jax_mesh.replicated(m))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    bshard = jax_mesh.batch_shardings(jb, m)
    step = shard_and_jit(jax_build_train_step(jm, tx, 1, 5.0,
                                              donate=False),
                         m, shardings, bshard, donate_state=False)
    new, metrics = step(jax.device_put(state, shardings),
                        jax.device_put(jb, bshard), jax.random.PRNGKey(0))
    return ({k: float(v) for k, v in metrics.items()},
            _flatten(jax.device_get(new.params)), shardings.params)


def _jax_pad(batch, multiple):
    """The JAX feeder's batch padding."""
    feeder = JaxDeviceFeeder([], JaxFrontendConfig(),
                             pad_batch_multiple=multiple)
    return feeder._pad_batch_dim(dict(batch))


def _lm_weights(vocab, seed=4):
    jlm = build_jax_lm(LM_CONF, vocab)
    toks = jnp.ones((1, 4), jnp.int32)
    shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0), toks,
                            jnp.array([4]), toks)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(_draw(rng, path[-1].key, leaf.shape)),
        shapes)


def _argv_decode(c, mode, ckpt, out, extra=()):
    return ["--config", c["cfg"], "--checkpoint", ckpt, "--test_data",
            c["data"]["manifest"], "--dict", c["data"]["dict"],
            "--result_file", out, "--mode", mode, "--batch_size", "4",
            "--beam_size", "3", "--reverse_weight", "0.3",
            *(["--timestamp_file", out + ".ts"] if mode != "attention"
              else []), *extra]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_parallel"))
    data = build_tiny(os.path.join(root, "data"), n_utts=8, seed=6,
                      max_dur=1.4)
    c = {"root": root, "data": data}
    tasks = []
    step_inputs = {}
    # train steps: (name, conf, model seed, batch seed, rows, dp, tp)
    for name, conf, seed, bseed, b, dp, tp in (
            ("dense_dp", DENSE, 0, 1, 3, 2, 1),
            ("dense_tp", DENSE, 0, 1, 3, 1, 2),
            ("lnl_dp", dict(DENSE, length_normalized_loss=True), 2, 3, 3,
             2, 1),
            ("moe_dp", MOE, 5, 7, 4, 2, 1),
            ("moe_tp", MOE, 5, 7, 4, 1, 2)):
        _, variables, flat, tm = tiny_models(seed, **conf)
        leaves = os.path.join(root, f"{name}.npz")
        np.savez(leaves, **flat)
        batch = _jax_pad(_batch(bseed, b), 2)
        bpath = os.path.join(root, f"{name}_batch.npz")
        np.savez(bpath, **batch)
        step_inputs[name] = (conf, variables, batch, tm)
        tasks.append({"kind": "step", "name": name, "dp": dp, "tp": tp,
                      "conf": dict(TINY_CONF, **conf), "leaves": leaves,
                      "batch": bpath, "feat_dim": FEAT_DIM, "vocab": VOCAB,
                      "lr": 1.0})
    tasks.append({"kind": "feeder", "name": "feeder",
                  "manifest": data["manifest"], "dict": data["dict"]})

    # decode: the dense model's weights as .npz and as a JAX checkpoint
    _, dvars, dflat, _ = tiny_models(0, **DENSE)
    c["npz"] = os.path.join(root, "dense.npz")
    np.savez(c["npz"], **dflat)
    jax_ckpt.save_checkpoint(root, "jax_dense", dvars)
    c["cfg"] = os.path.join(root, "dense.json")
    with open(c["cfg"], "w") as f:
        json.dump({"model_conf": dict(TINY_CONF, **DENSE),
                   "vocab_size": VOCAB}, f)
    c["arpa"] = os.path.join(root, "lm.arpa")
    _write_arpa(c["arpa"], data["dict"])
    decodes = [(m, []) for m in MODES] + [
        ("attention_rescoring", ["--ngram_lm", c["arpa"], "--lm_weight",
                                 "0.5"])]
    for i, (mode, extra) in enumerate(decodes):
        out = os.path.join(root, f"dp2_{i}.txt")
        tasks.append({"kind": "cli", "cli": "recognize", "name": f"dec{i}",
                      "argv": _argv_decode(c, mode, c["npz"], out, extra)
                      + ["--dp", "2", "--device", "cpu"]})
    tasks.append({"kind": "cli", "cli": "recognize", "name": "multiple",
                  "raises": True,
                  "argv": _argv_decode(c, "ctc_greedy_search", c["npz"],
                                       os.path.join(root, "x.txt"))[:-2]
                  + ["--dp", "2", "--batch_size", "3", "--device", "cpu"]})

    # train_lm from the same weights in both packages
    vocab = len(load_dict(data["dict"]))
    lm_vars = _lm_weights(vocab)
    jax_ckpt.save_checkpoint(root, "jax_lm", lm_vars)
    tlm = build_language_model(LM_CONF, vocab)
    tlm.load_state_dict(flax_to_state_dict(_flatten(lm_vars), tlm))
    c["lm_pt"] = os.path.join(root, "lm.pt")
    torch.save(tlm.state_dict(), c["lm_pt"])
    c["lm_cfg"] = os.path.join(root, "lm.json")
    with open(c["lm_cfg"], "w") as f:
        json.dump({"model_conf": LM_CONF, "dataset_conf": {"batch_size": 2},
                   "optim_conf": {"lr": 0.002}, "warmup_steps": 2,
                   "log_interval": 1, "seed": 3, "max_epoch": 1}, f)
    for flag in ("--dp", "--tp"):
        tasks.append({"kind": "cli", "cli": "train_lm",
                      "name": f"lm{flag[2:]}", "argv": [
                          "--config", c["lm_cfg"], "--train_data",
                          data["text"], "--cv_data", data["text"], "--dict",
                          data["dict"], "--exp_dir",
                          os.path.join(root, f"lm{flag[2:]}"), "--device",
                          "cpu", "--num_workers", "1", "--checkpoint",
                          c["lm_pt"], flag, "2"]})

    # train at --tp 2 (checkpoint layout) and two nodes (--multihost)
    c["train_cfg"] = os.path.join(root, "train.json")
    with open(c["train_cfg"], "w") as f:
        json.dump({"model_conf": dict(TINY_CONF, dropout_rate=0.1),
                   "collate_conf": {"spec_aug": True},
                   "dataset_conf": {"batch_type": "dynamic",
                                    "max_frames_in_batch": 300},
                   "optim_conf": {"lr": 0.002}, "warmup_steps": 2,
                   "log_interval": 1, "seed": 11}, f)
    for name, extra, env in (
            ("train_tp", ["--tp", "2"], {}),
            ("train_mh", ["--dp", "2", "--multihost"],
             {"LOCAL_WORLD_SIZE": "1", "LOCAL_RANK": "0"})):
        tasks.append({"kind": "cli", "cli": "train", "name": name,
                      "env": env, "argv": [
                          "--config", c["train_cfg"], "--train_data",
                          data["manifest"], "--cv_data", data["manifest"],
                          "--dict", data["dict"], "--exp_dir",
                          os.path.join(root, name), "--device", "cpu",
                          "--num_workers", "1", "--max_epoch", "1", *extra]})
    with open(os.path.join(root, "tasks.json"), "w") as f:
        json.dump(tasks, f)
    procs = spawn(root, 2)
    try:
        # the JAX side meanwhile
        ref = {}
        for name, (data_ax, model_ax) in (("dense_dp", (2, 1)),
                                          ("dense_tp", (1, 2)),
                                          ("lnl_dp", (2, 1)),
                                          ("moe", (2, 2))):
            src = {"moe": "moe_dp"}.get(name, name)
            conf, variables, batch, _ = step_inputs[src]
            ref[name] = _jax_step(conf, variables, batch, data_ax, model_ax)
        for mode in JAX_MODES:
            out = os.path.join(root, f"jax_{mode}.txt")
            jax_recognize.main(_argv_decode(c, mode,
                                            os.path.join(root, "jax_dense"),
                                            out) + ["--dp", "2"])
        jax_train_lm.main(["--config", c["lm_cfg"], "--train_data",
                           data["text"], "--cv_data", data["text"],
                           "--dict", data["dict"], "--exp_dir",
                           os.path.join(root, "jax_lm_exp"),
                           "--num_workers", "0", "--checkpoint",
                           os.path.join(root, "jax_lm"), "--dp", "2",
                           "--tp", "2"])
    finally:
        wait(procs, root)
    c.update(ref=ref, steps=step_inputs, decodes=decodes, vocab=vocab)
    return c


def _load(job, name, rank=None):
    tag = name if rank is None else f"{name}.{rank}"
    return torch.load(os.path.join(job["root"], f"{tag}.pt"),
                      weights_only=False)


def _assert_step(job, name, ref):
    metrics, params, _ = job["ref"][ref]
    got = _load(job, name)
    for key in ("loss", "loss_ctc", "loss_att", "acc", "grad_norm",
                "moe_aux"):
        if key in metrics:
            np.testing.assert_allclose(got["metrics"][key], metrics[key],
                                       rtol=1e-5, err_msg=key)
    tm = job["steps"][name][3]
    want = flax_to_state_dict(params, tm)
    before = tm.state_dict()
    for k, w in want.items():
        step = (w - before[k]).abs().max()
        err = (got["params"][k] - w).abs().max()
        assert err <= 1e-4 * step + 1e-7, (k, float(err), float(step))


@pytest.mark.parametrize("name,ref", [("dense_dp", "dense_dp"),
                                      ("dense_tp", "dense_tp"),
                                      ("lnl_dp", "lnl_dp"),
                                      ("moe_dp", "moe"), ("moe_tp", "moe")])
def test_step_matches_the_jax_mesh(job, name, ref):
    _assert_step(job, name, ref)


def test_tp_rules_and_sharded_parameters():
    """The port's TP_RULES are JAX's; at tp = 2 a port parameter shards
    where JAX's leaf shards (Dense weights on the transposed axis), plus
    the column-parallel biases and the heads' pos_bias rows; at an odd
    vocab the embedding and the output layers stay replicated."""
    assert [(r, tuple(s)) for r, s in jax_mesh.TP_RULES] == \
        [(r, s) for r, s in mesh.TP_RULES]
    for vocab in (VOCAB, VOCAB + 1):
        tm = build_asr_model(dict(TINY_CONF, **MOE), FEAT_DIM, vocab)
        plan = mesh.tp_plan(tm, 2)
        from openeat_tpu.models.asr_model import build_asr_model as jb
        shapes = jax.eval_shape(
            jb(dict(TINY_CONF, **MOE), FEAT_DIM, vocab).init,
            jax.random.PRNGKey(0), jnp.zeros((1, 40, FEAT_DIM)),
            jnp.array([40]), jnp.ones((1, 4), jnp.int32), jnp.array([4]))
        m = jax_mesh.make_mesh(1, 2)
        jspec = {"/".join(str(getattr(k, "key", k)) for k in path): s.spec
                 for path, s in jax.tree_util.tree_flatten_with_path(
                     jax_mesh.param_shardings(shapes, m))[0]}
        for leaf, spec in jspec.items():
            if "model" not in tuple(spec):
                continue
            mod = ".".join(leaf.split("/")[1:-1])
            assert mod in plan or mod.rsplit(".", 1)[0] in plan, leaf
        odd = vocab % 2 == 1
        for head in ("ctc.ctc_lo", "decoder.left_decoder.embed",
                     "decoder.left_decoder.output_layer"):
            assert (head in plan) != odd, (vocab, head)
            jleaf = "params/" + head.replace(".", "/") + (
                "/embedding" if head.endswith("embed") else "/kernel")
            assert ("model" in tuple(jspec[jleaf])) != odd
        assert plan["encoder.encoders.layer_0.feed_forward"] == "experts"
        assert plan["encoder.encoders.layer_0.self_attn"] == "attention"


def test_moe_batch_saturates_and_capacity_is_global(job):
    """The premise of the MoE steps: their batch drops tokens, and a
    rank that computed capacity and positions from its own rows alone
    would keep another set."""
    _, _, batch, tm = job["steps"]["moe_dp"]
    seen = []
    hook = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, *args)))
        for m in tm.modules() if isinstance(m, MoEPositionwiseFeedForward)]
    with torch.no_grad():
        tm.encode(torch.from_numpy(batch["features"]),
                  torch.from_numpy(batch["features_length"]).long())
    for h in hook:
        h.remove()
    dropped = naive_differs = 0
    for mod, x, pad in seen:
        sel, keep = mod.route(x, pad)[1:3]
        dropped += int((sel > 0).sum() - keep.sum())
        half = x.shape[0] // 2
        for rows in (slice(0, half), slice(half, None)):
            local = mod.route(x[rows], pad[rows])[2]
            t = x.shape[1]
            own = keep.view(x.shape[0], t, -1)[rows].reshape(local.shape)
            naive_differs += int((local != own).sum())
    assert dropped > 0 and naive_differs > 0, (dropped, naive_differs)


def test_dp_feeder_rows_equal_the_single_process_rows(job):
    for rank in range(2):
        got = _load(job, "feeder", rank)
        assert got["errors"] and max(got["errors"]) == 0.0, got


def test_recognize_dp2_files_equal_dp1_and_jax(job):
    root = job["root"]
    for i, (mode, extra) in enumerate(job["decodes"]):
        dp1 = os.path.join(root, f"dp1_{i}.txt")
        recognize.main(_argv_decode(job, mode, job["npz"], dp1, extra)
                       + ["--device", "cpu"])
        dp2 = os.path.join(root, f"dp2_{i}.txt")
        files = [".ts"] if mode != "attention" else []
        for ext in [""] + files:
            with open(dp1 + ext, encoding="utf-8") as a, \
                    open(dp2 + ext, encoding="utf-8") as b:
                assert a.read() == b.read(), (mode, extra, ext)
        if not extra and mode in JAX_MODES:
            jax_out = os.path.join(root, f"jax_{mode}.txt")
            for ext in ["", ".ts"]:
                with open(jax_out + ext, encoding="utf-8") as a, \
                        open(dp2 + ext, encoding="utf-8") as b:
                    assert a.read() == b.read(), (mode, ext)
    with open(os.path.join(root, "dp2_0.txt"), encoding="utf-8") as f:
        assert len(f.read().splitlines()) == 8


def test_recognize_batch_not_a_multiple_of_dp_raises(job):
    for rank in range(2):
        assert "multiple of" in _load(job, "multiple", rank)["message"]


def test_dp_outside_torchrun_raises(job, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for extra in (["--dp", "2"], ["--tp", "2"], ["--multihost"]):
        with pytest.raises(ValueError, match="torch.distributed.run"):
            train.main(["--config", job["train_cfg"], "--train_data",
                        job["data"]["manifest"], "--cv_data",
                        job["data"]["manifest"], "--dict",
                        job["data"]["dict"], "--exp_dir",
                        os.path.join(job["root"], "refused"), "--device",
                        "cpu", *extra])
    with pytest.raises(ValueError, match="torch.distributed.run"):
        recognize.main(_argv_decode(job, "ctc_greedy_search", job["npz"],
                                    os.path.join(job["root"], "r.txt"))
                       + ["--dp", "2", "--device", "cpu"])


@pytest.mark.parametrize("layout", ["dp", "tp"])
def test_train_lm_matches_jax_dp2_tp2(job, layout):
    root = job["root"]
    with open(os.path.join(root, "jax_lm_exp", "epoch_1.yaml")) as f:
        j_info = yaml.safe_load(f)
    j_params, _ = jax_ckpt.load_checkpoint(
        os.path.join(root, "jax_lm_exp", "epoch_1"))
    with open(os.path.join(root, f"lm{layout}", "epoch_1.json")) as f:
        info = json.load(f)
    assert info["step"] == j_info["step"] == 4
    for key in ("cv_loss", "cv_acc"):
        np.testing.assert_allclose(info[key], j_info[key], rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    tlm = build_language_model(LM_CONF, job["vocab"])
    want = flax_to_state_dict(_flatten(j_params), tlm)
    got = torch.load(os.path.join(root, f"lm{layout}", "epoch_1.pt"),
                     weights_only=True)
    start = torch.load(job["lm_pt"], weights_only=True)
    for k, w in want.items():
        change = float((w - start[k]).abs().max())
        err = float((got[k] - w).abs().max())
        # the attention key biases' gradient is rounding noise (softmax
        # shift invariance), which Adam turns into steps of up to lr
        bound = 2 * 0.002 * 4 if k.endswith("linear_k.bias") \
            else 1e-4 + 1e-3 * change
        assert err <= bound, (k, err, change)


def test_tp2_checkpoint_is_the_full_model(job):
    root = job["root"]
    full = torch.load(os.path.join(root, "train_tp", "epoch_1.pt"),
                      weights_only=True)
    vocab = job["vocab"]
    model = build_asr_model(dict(TINY_CONF, dropout_rate=0.1), 80, vocab)
    model.load_state_dict(full, strict=True)        # loads at tp = 1
    ranks = [_load(job, "train_tp", r) for r in range(2)]
    assert ranks[0]["dims"] and ranks[0]["step"] == ranks[1]["step"] > 0
    for r, shards in enumerate(ranks):
        for name, shard in shards["shards"].items():
            d = shards["dims"][name]
            k = shard.shape[d]
            torch.testing.assert_close(full[name].narrow(d, r * k, k), shard,
                                       rtol=0, atol=0)
    opt = torch.load(os.path.join(root, "train_tp", "optimizer.pt"),
                     weights_only=True)
    shapes = [tuple(p.shape) for p in model.parameters()]
    for idx, st in opt["optimizer"]["state"].items():
        assert tuple(st["exp_avg"].shape) == shapes[idx]


def test_multihost_loader_and_run_shard_by_node(job):
    manifest, d = job["data"]["manifest"], job["data"]["dict"]
    kw = dict(batch_type="dynamic", max_frames_in_batch=300)
    t_ds = AudioDataset(manifest, load_dict(d), **kw)
    j_ds = JaxAudioDataset(manifest, jax_load_dict(d), **kw)

    def keys(batch):
        return [u.key for u in batch]

    assert len(t_ds) >= 3
    for shard in range(2):
        t = list(PrefetchLoader(t_ds, keys, 1, shuffle_batches=True,
                                seed=11, shard_id=shard, num_shards=2))
        j = list(JaxPrefetchLoader(j_ds, keys, 1, shuffle_batches=True,
                                   seed=11, shard_id=shard, num_shards=2))
        assert t == j and len(t) == -(-len(t_ds) // 2)
    with open(os.path.join(job["root"], "train_mh", "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f
                 if json.loads(line)["kind"] == "train"]
    assert len(steps) == -(-len(t_ds) // 2)
    assert all(np.isfinite(s["loss"]) for s in steps)


def test_tp_checkpoint_shards_and_gathers_back(job):
    """Sharding a loaded checkpoint and gathering it back is exact, at
    tp = 2 over the two ranks' saved shards."""
    tm = job["steps"]["dense_tp"][3]
    shards = [_load(job, "dense_tp", r)["shards"] for r in range(2)]
    plan = _load(job, "dense_tp")["plan"]
    assert set(plan) == set(shards[0])
    got = _load(job, "dense_tp")["params"]
    for name, d in plan.items():
        torch.testing.assert_close(torch.cat([s[name] for s in shards], d),
                                   got[name], rtol=0, atol=0)
        assert got[name].shape == tm.state_dict()[name].shape
