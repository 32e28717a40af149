"""openeat_torch's language-model slice against the JAX package, on the
CPU (float32, dropout 0):
- the Transformer LM, autoregressive and masked: loss and accuracy
  within 1e-5 relative, and every parameter's gradient within 1e-4 of
  that tensor's max |grad| plus 1e-7 of the model's largest (the
  attention key biases' gradient is rounding noise in both), mapped
  through the weight bridge; log_probs and mlm_log_probs within 1e-5;
- TextDataset and TextCollate: the same rows, batches and, for a seed,
  the same masked inputs and targets over consecutive batches;
- ArpaLM, BinaryNgramLM and load_lm: the same log10 scores on one ARPA
  file;
- rescoring_scores with the Transformer LM fused, "ar" and "mlm",
  within 1e-4 of JAX's;
- recognize's LM loader takes a .pt state_dict and an .npz of flax
  leaves alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openeat_tpu.dataset.dataset import TextCollate as JaxTextCollate
from openeat_tpu.dataset.dataset import TextDataset as JaxTextDataset
from openeat_tpu.decode.rescoring import \
    rescoring_scores as jax_rescoring_scores
from openeat_tpu.lm import ngram as jax_ngram
from openeat_tpu.models.language_model import LanguageModel as JaxLM
from openeat_tpu.models.language_model import \
    build_language_model as build_jax_lm
from openeat_tpu.utils.checkpoint import _flatten
from openeat_torch.bin import recognize
from openeat_torch.dataset.dataset import TextCollate, TextDataset
from openeat_torch.decode.rescoring import rescoring_scores
from openeat_torch.lm import ngram
from openeat_torch.models.language_model import build_language_model
from openeat_torch.utils.common import IGNORE_ID
from openeat_torch.utils.param_bridge import flax_to_state_dict
from tests._torch_parity import VOCAB, _draw, tiny_models, to_np

torch.set_num_threads(1)
LM_CONF = dict(d_model=32, attention_heads=4, linear_units=64, num_blocks=2,
               dropout_rate=0.0, activation="relu", lsm_weight=0.1,
               compute_dtype="float32")


def lm_models(seed: int = 0, **overrides):
    """(jax LM, flax variables, port LM) with the same drawn weights."""
    conf = dict(LM_CONF, **overrides)
    jlm = build_jax_lm(conf, VOCAB)
    toks = jnp.ones((1, 4), jnp.int32)
    shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0), toks,
                            jnp.array([4]), toks)
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(_draw(rng, path[-1].key, leaf.shape)),
        shapes)
    tlm = build_language_model(conf, VOCAB)
    tlm.load_state_dict(flax_to_state_dict(_flatten(variables), tlm),
                        strict=True)
    return jlm, variables, tlm.eval()


def _tokens(seed=1, b=3, l=9):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, VOCAB - 1, (b, l)).astype(np.int32)
    lens = np.array([l, l - 3, 2], np.int32)
    toks[np.arange(l)[None, :] >= lens[:, None]] = IGNORE_ID
    return toks, lens


@pytest.mark.parametrize("autoregressive", [True, False],
                         ids=["ar", "mlm"])
def test_lm_loss_and_every_gradient_match_jax(autoregressive):
    jlm, variables, tlm = lm_models(0, autoregressive=autoregressive)
    toks, lens = _tokens()
    masked = None
    if not autoregressive:
        rng = np.random.default_rng(4)
        pick = (rng.random(toks.shape) < 0.4) & (toks != IGNORE_ID)
        masked = np.where(pick, toks, IGNORE_ID).astype(np.int32)
        toks = np.where(pick, VOCAB - 1, toks).astype(np.int32)
    j_args = [jnp.asarray(toks), jnp.asarray(lens)] + (
        [] if masked is None else [jnp.asarray(masked)])

    def loss_fn(v):
        m = jlm.apply(v, *j_args)
        return m["loss"], m

    (_, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables)
    tlm.train()
    t_args = [torch.from_numpy(toks).long(), torch.from_numpy(lens).long()]
    if masked is not None:
        t_args.append(torch.from_numpy(masked).long())
    metrics = tlm(*t_args)
    metrics["loss"].backward()
    for key in ("loss", "acc"):
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(j_metrics[key]), rtol=1e-5,
                                   err_msg=key)
    want = flax_to_state_dict(_flatten(j_grads), tlm)
    g_max = max(float(g.abs().max()) for g in want.values())
    for name, p in tlm.named_parameters():
        ref = want[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max() + 1e-7 * g_max, (name, err)


def test_lm_log_probs_match_jax():
    jlm, variables, tlm = lm_models(1)
    toks, lens = _tokens(2)
    toks = np.where(toks == IGNORE_ID, VOCAB - 1, toks)
    for method, j_method in (("log_probs", JaxLM.log_probs),
                             ("mlm_log_probs", JaxLM.mlm_log_probs)):
        with torch.no_grad():
            got = getattr(tlm, method)(torch.from_numpy(toks).long(),
                                       torch.from_numpy(lens).long())
        want = jlm.apply(variables, jnp.asarray(toks), jnp.asarray(lens),
                         method=j_method)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-5)


def test_text_dataset_and_masking_match_jax(tmp_path):
    d = {"<blank>": 0, "<unk>": 1, **{chr(0x4E00 + i): i + 2
                                      for i in range(30)}, "<sos/eos>": 32}
    rng = np.random.default_rng(5)
    lines = []
    for i in range(23):
        text = "".join(chr(0x4E00 + int(j))
                       for j in rng.integers(0, 31, rng.integers(1, 14)))
        lines.append(f"utt{i} {text}" if i % 3 else text + "，")
    path = tmp_path / "text"
    path.write_text("\n".join(lines) + "\n\n", encoding="utf-8")
    kw = dict(token_max_length=12, token_min_length=1, batch_size=4)
    ds = TextDataset(str(path), d, **kw)
    jds = JaxTextDataset(str(path), d, **kw)
    assert len(ds) == len(jds) > 3
    for autoregressive in (True, False):
        coll = TextCollate(len(d), autoregressive, seed=9)
        jcoll = JaxTextCollate(len(d), autoregressive, seed=9)
        for i in range(len(ds)):
            got, want = coll(ds[i]), jcoll(jds[i])
            assert got.keys() == want.keys()
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    assert (want["masked_targets"] != IGNORE_ID).any()


ARPA = """\\data\\
ngram 1=6
ngram 2=4
ngram 3=2

\\1-grams:
-1.0\t<s>\t-0.5
-1.2\t</s>
-0.8\tHELLO\t-0.3
-0.9\tWORLD\t-0.4
-1.1\tGOOD\t-0.2
-2.0\t<unk>

\\2-grams:
-0.2\t<s> HELLO\t-0.1
-0.3\tHELLO WORLD\t-0.15
-0.4\tWORLD </s>
-0.6\tGOOD WORLD

\\3-grams:
-0.05\t<s> HELLO WORLD
-0.07\tHELLO WORLD </s>

\\end\\
"""


def test_ngram_scores_match_jax(tmp_path):
    arpa = tmp_path / "lm.arpa"
    arpa.write_text(ARPA)
    binp = str(tmp_path / "lm.bin")
    ngram.ArpaLM.load(str(arpa)).save_binary(binp)
    with open(binp, "rb") as f:
        port_bytes = f.read()
    jax_bin = str(tmp_path / "jax.bin")
    jax_ngram.ArpaLM.load(str(arpa)).save_binary(jax_bin)
    with open(jax_bin, "rb") as f:
        assert f.read() == port_bytes
    models = [(ngram.load_lm(str(arpa)), jax_ngram.load_lm(str(arpa))),
              (ngram.load_lm(binp), jax_ngram.load_lm(binp))]
    assert isinstance(models[1][0], ngram.BinaryNgramLM)
    for sent in ("HELLO WORLD", "WORLD HELLO", "GOOD WORLD XYZ",
                 "HELLO HELLO WORLD GOOD", ""):
        for kw in ({}, dict(bos=False), dict(eos=False)):
            for port, ref in models:
                assert port.score(sent, **kw) == ref.score(sent, **kw)


@pytest.mark.parametrize("autoregressive", [True, False],
                         ids=["ar", "mlm"])
def test_lm_fused_rescoring_matches_jax(autoregressive):
    jm, variables, _, tm = tiny_models(0)
    jlm, lm_vars, tlm = lm_models(2, autoregressive=autoregressive)
    rng = np.random.default_rng(6)
    enc = rng.standard_normal((2, 11, 64)).astype(np.float32)
    enc_lens = np.array([11, 7], np.int32)
    hyps = rng.integers(1, VOCAB - 1, (2, 3, 5)).astype(np.int32)
    hyp_lens = np.array([[5, 2, 0], [3, 4, 1]], np.int32)
    hyps[np.arange(5)[None, None, :] >= hyp_lens[..., None]] = IGNORE_ID
    ctc = np.array([[-1.0, -2.5, -np.inf], [-0.5, -3.0, -4.0]], np.float32)
    style = "ar" if autoregressive else "mlm"
    method = tlm.log_probs if autoregressive else tlm.mlm_log_probs
    j_method = JaxLM.log_probs if autoregressive else JaxLM.mlm_log_probs
    kw = dict(ctc_weight=0.5, reverse_weight=0.3, lm_weight=0.3,
              lm_style=style)
    with torch.no_grad():
        args = [torch.from_numpy(x) for x in (enc, enc_lens, hyps,
                                              hyp_lens, ctc)]
        fused = rescoring_scores(tm, *args, lm_logp_fn=method, **kw)
        plain = rescoring_scores(tm, *args, ctc_weight=0.5,
                                 reverse_weight=0.3)
    want = jax.jit(lambda *a: jax_rescoring_scores(
        jm, variables, *a,
        lm_logp_fn=lambda t, l: jlm.apply(lm_vars, t, l, method=j_method),
        **kw))(*(jnp.asarray(x) for x in (enc, enc_lens, hyps, hyp_lens,
                                          ctc)))
    np.testing.assert_allclose(to_np(fused), to_np(want), atol=1e-4,
                               rtol=1e-4)
    assert (fused != plain)[:, :2].all()


def test_lm_checkpoints_load_from_pt_and_npz(tmp_path):
    """recognize's --lm_checkpoint takes the port's .pt state_dict and an
    .npz of flax leaves alike."""
    _, variables, tlm = lm_models(3)
    npz, pt = str(tmp_path / "lm.npz"), str(tmp_path / "lm.pt")
    np.savez(npz, **_flatten(variables))
    torch.save(tlm.state_dict(), pt)
    cfg = {"model_conf": LM_CONF}
    toks, lens = _tokens(4)
    toks = torch.from_numpy(np.where(toks == IGNORE_ID, VOCAB - 1, toks))
    lens = torch.from_numpy(lens)
    with torch.no_grad():
        want = tlm.log_probs(toks, lens)
        for path in (npz, pt):
            lm = recognize.load_language_model(cfg, path, VOCAB,
                                               torch.device("cpu"))
            assert not lm.training
            assert torch.equal(lm.log_probs(toks, lens), want)
