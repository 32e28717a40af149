"""Offline decoding entry point (PyTorch).

Port of openeat_tpu/bin/recognize.py: reads a manifest, extracts
features on the device, encodes whole batches and decodes them with
ctc_greedy_search, ctc_prefix_beam_search, attention (the KV-cached
beam search; --adaptive_steps bounds its steps by the CTC greedy
lengths, --length_penalty adds a per-token bonus at the final pick) or
attention_rescoring, and writes `<utt> <text>` lines. The flags are the
JAX entry point's, plus --device (default cuda; cpu must be asked for).

--checkpoint takes the port's own state_dict (.pt) or an .npz of flax
leaves as openeat_tpu/utils/checkpoint.py:_flatten keys them, converted
through openeat_torch/utils/param_bridge.py; so does --lm_checkpoint.
With --lm_weight > 0, attention_rescoring fuses a Transformer LM
(--lm_config, --lm_checkpoint; on the device) or an ARPA/binary n-gram
(--ngram_lm; on the host). --timestamp_file writes JSONL {key, tokens,
times_ms} of the CTC emission onsets (one encoder position = subsampling
rate x 10 ms) in the CTC-alignment modes. --quantize int8 decodes with
int8 weight-only Dense weights (utils/quantize.py).

Not ported yet, refused with NotImplementedError: --dp other than 1,
--bpe_model, --data_type feat/kaldi and WeNet-layout configs.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from openeat_torch.config import load_config
from openeat_torch.dataset.dataset import (AudioCollate, AudioDataset,
                                           PrefetchLoader)
from openeat_torch.dataset.text import load_dict, token_ids_to_text
from openeat_torch.decode.attention_beam import adaptive_max_steps
from openeat_torch.decode.attention_beam import recognize as attention_decode
from openeat_torch.decode.ctc_greedy import ctc_greedy_search
from openeat_torch.decode.ctc_prefix_beam import ctc_prefix_beam_search
from openeat_torch.decode.rescoring import (attention_rescoring,
                                            rescoring_scores)
from openeat_torch.lm.ngram import load_lm
from openeat_torch.models.asr_model import ASRModel, build_asr_model
from openeat_torch.models.language_model import (LanguageModel,
                                                 build_language_model)
from openeat_torch.ops.frontend import FrontendConfig
from openeat_torch.pipeline import DeviceFeeder
from openeat_torch.utils.common import init_logger, resolve_device
from openeat_torch.utils.param_bridge import flax_to_state_dict
from openeat_torch.utils.quantize import quantize_model, quantized_bytes

MODES = ["ctc_greedy_search", "ctc_prefix_beam_search", "attention",
         "attention_rescoring"]
# ms of audio per encoder position: 10 ms frames through the conv2d x4
# subsampling, the one input layer ported (build_asr_model refuses the
# others)
POS_MS = 40.0


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="decode with an ASR model "
                                            "(PyTorch)")
    p.add_argument("--config", required=True, help="train config, "
                   ".json or .yaml")
    p.add_argument("--checkpoint", required=True,
                   help="port state_dict (.pt) or flax leaves (.npz)")
    p.add_argument("--test_data", required=True)
    p.add_argument("--result_file", required=True)
    p.add_argument("--dict", dest="dict_path", required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a CUDA "
                        "device raises")
    p.add_argument("--bpe_model", default=None)
    p.add_argument("--mode", default="attention_rescoring", choices=MODES)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--beam_size", type=int, default=10)
    p.add_argument("--ctc_weight", type=float, default=0.5)
    p.add_argument("--reverse_weight", type=float, default=0.0)
    p.add_argument("--max_hyp_len", type=int, default=64)
    p.add_argument("--adaptive_steps", type=int, default=0)
    p.add_argument("--length_penalty", type=float, default=0.0)
    p.add_argument("--lm_config", default=None)
    p.add_argument("--lm_checkpoint", default=None)
    p.add_argument("--lm_weight", type=float, default=0.0)
    p.add_argument("--ngram_lm", default=None)
    p.add_argument("--data_type", default="wav",
                   choices=["wav", "feat", "kaldi"])
    p.add_argument("--quantize", default="none", choices=["none", "int8"],
                   help="int8: per-channel weight-only quantization of "
                        "the Dense weights (utils/quantize.py)")
    p.add_argument("--timestamp_file", default=None)
    p.add_argument("--dp", type=int, default=1)
    return p


def refuse_unported(args, cfg: dict) -> None:
    """Raise NotImplementedError for what this port does not do yet."""
    later = {
        "--dp": (args.dp != 1, "the parallel-layout slice"),
        "--bpe_model": (args.bpe_model is not None,
                        "a later slice (BPE tokenizer)"),
        "--data_type feat/kaldi": (args.data_type != "wav",
                                   "a later slice (kaldi ark input)"),
        "WeNet-layout config": ("encoder_conf" in cfg
                                or "decoder_conf" in cfg,
                                "a later slice (convert_wenet)"),
    }
    for what, (asked, where) in later.items():
        if asked:
            raise NotImplementedError(
                f"{what} is not ported to openeat_torch yet; it comes "
                f"with {where}")


def _read_checkpoint(checkpoint: str) -> dict:
    """An .npz of flax leaves (keyed as _flatten keys them) or a .pt
    state_dict, as a dict."""
    if checkpoint.endswith(".npz"):
        with np.load(checkpoint) as z:
            return {k: z[k] for k in z.files}
    return torch.load(checkpoint, map_location="cpu", weights_only=True)


def load_model(cfg: dict, checkpoint: str, vocab_size: int,
               device: torch.device, quantize: str = "none") -> ASRModel:
    """Build the model from `cfg` and fill it from `checkpoint`. Whether
    the encoder has global CMVN is read from the checkpoint; a config
    that says otherwise is an error. quantize="int8" quantizes the
    weights on the host, before they move to `device`, and logs their
    size."""
    state = _read_checkpoint(checkpoint)
    has_cmvn = ("params/encoder/global_cmvn/mean" if checkpoint.endswith(
        ".npz") else "encoder.global_cmvn.mean") in state
    use_global_cmvn = cfg.get("use_global_cmvn", has_cmvn)
    if use_global_cmvn != has_cmvn:
        raise ValueError(f"config sets use_global_cmvn={use_global_cmvn} "
                         f"but the checkpoint {checkpoint} "
                         f"{'has' if has_cmvn else 'lacks'} global_cmvn "
                         "parameters")
    model = build_asr_model(dict(cfg.get("model_conf", {}) or {}),
                            cfg.get("input_size", 80),
                            cfg.get("vocab_size", vocab_size),
                            use_global_cmvn=use_global_cmvn)
    if checkpoint.endswith(".npz"):
        state = flax_to_state_dict(state, model)
    model.load_state_dict(state, strict=True)
    if quantize == "int8":
        quantize_model(model)
        now, fp32 = quantized_bytes(model)
        init_logger().info("int8 weight quantization: %.1f MB (%.2fx vs "
                           "fp32)", now / 1e6, fp32 / max(now, 1))
    return model.to(device).eval()


def load_language_model(lm_cfg: dict, checkpoint: str, vocab_size: int,
                        device: torch.device) -> LanguageModel:
    """The Transformer LM of `lm_cfg`'s model_conf, sized to the ASR
    dict, from a .pt state_dict or an .npz of flax leaves."""
    lm = build_language_model(dict(lm_cfg.get("model_conf", {}) or {}),
                              vocab_size)
    state = _read_checkpoint(checkpoint)
    if checkpoint.endswith(".npz"):
        state = flax_to_state_dict(state, lm)
    lm.load_state_dict(state, strict=True)
    return lm.to(device).eval()


def main(argv=None):
    args = get_parser().parse_args(argv)
    logger = init_logger()
    cfg = load_config(args.config)
    refuse_unported(args, cfg)
    want_times = args.timestamp_file is not None
    if want_times and args.mode == "attention":
        raise SystemExit("--timestamp_file needs a CTC frame alignment; "
                         "the attention mode has none (use "
                         "ctc_greedy_search / ctc_prefix_beam_search / "
                         "attention_rescoring)")
    device = resolve_device(args.device)
    char_dict = load_dict(args.dict_path)
    model = load_model(cfg, args.checkpoint, len(char_dict), device,
                       args.quantize)
    id2tok = {v: k for k, v in char_dict.items()}
    collate_conf = dict(cfg.get("collate_conf", {}) or {})
    fe_conf = collate_conf.get("feature_extraction_conf", {}) or {}
    dataset_conf = dict(cfg.get("dataset_conf", {}) or {})
    test_ds = AudioDataset(
        args.test_data, char_dict,
        max_length=dataset_conf.get("max_length", 10240),
        min_length=dataset_conf.get("min_length", 0),
        token_max_length=dataset_conf.get("token_max_length", 200),
        batch_size=args.batch_size, sort=True)
    collate = AudioCollate(resample_rate=fe_conf.get("resample_rate", 16000))
    frontend = FrontendConfig.from_collate_conf(
        collate_conf).without_augmentation()
    feeder = DeviceFeeder(PrefetchLoader(test_ds, collate, num_workers=4),
                          frontend, device,
                          pad_batch_multiple=args.batch_size)

    lm_logp_fn, lm_style, ngram = None, "ar", None
    if args.lm_weight > 0 and args.lm_config and args.lm_checkpoint:
        lm = load_language_model(load_config(args.lm_config),
                                 args.lm_checkpoint, len(char_dict), device)
        lm_style = "ar" if lm.autoregressive else "mlm"
        lm_logp_fn = lm.log_probs if lm.autoregressive else lm.mlm_log_probs
    elif args.lm_weight > 0 and args.ngram_lm:
        ngram = load_lm(args.ngram_lm)
    ts_out = (open(args.timestamp_file, "w", encoding="utf-8")
              if want_times else None)

    n_done = 0
    os.makedirs(os.path.dirname(os.path.abspath(args.result_file)),
                exist_ok=True)
    with open(args.result_file, "w", encoding="utf-8") as fout, \
            torch.inference_mode():
        for keys, batch in feeder:
            enc, enc_lens = model.encode(batch["features"],
                                         batch["features_length"])
            times = None
            if args.mode == "attention":
                max_steps = min(int(enc.shape[1]), args.max_hyp_len)
                if args.adaptive_steps:
                    _, glens = ctc_greedy_search(model.ctc_log_probs(enc),
                                                 enc_lens)
                    max_steps = adaptive_max_steps(glens, cap=max_steps)
                hyps, hyp_lens, _ = attention_decode(
                    model, enc, enc_lens, beam_size=args.beam_size,
                    max_steps=max_steps, length_penalty=args.length_penalty)
            elif args.mode == "ctc_greedy_search":
                out = ctc_greedy_search(model.ctc_log_probs(enc), enc_lens,
                                        return_times=want_times)
                hyps, hyp_lens = out[:2]
                if want_times:
                    times = out[2]
            else:
                out = ctc_prefix_beam_search(
                    model.ctc_log_probs(enc), enc_lens,
                    beam_size=args.beam_size, max_hyp_len=args.max_hyp_len,
                    return_times=want_times)
                nbest, nbest_lens, nbest_scores = out[:3]
                if args.mode == "ctc_prefix_beam_search":
                    win = torch.zeros(len(nbest), dtype=torch.long)
                    hyps, hyp_lens = nbest[:, 0], nbest_lens[:, 0]
                elif ngram is not None:
                    hyps, hyp_lens, win = _ngram_rescore(
                        model, enc, enc_lens, nbest, nbest_lens,
                        nbest_scores, ngram, id2tok, args)
                else:
                    hyps, hyp_lens, _, win = attention_rescoring(
                        model, enc, enc_lens, nbest, nbest_lens,
                        nbest_scores, ctc_weight=args.ctc_weight,
                        reverse_weight=args.reverse_weight,
                        lm_logp_fn=lm_logp_fn,
                        lm_weight=args.lm_weight if lm_logp_fn else 0.0,
                        lm_style=lm_style)
                if want_times:
                    times = out[3].cpu()[torch.arange(len(nbest)),
                                         torch.as_tensor(win).cpu()]
            hyps = torch.as_tensor(hyps).cpu().numpy()
            hyp_lens = torch.as_tensor(hyp_lens).cpu().numpy()
            if times is not None:
                times = times.cpu().numpy()
            for i, key in enumerate(keys):
                text = token_ids_to_text(hyps[i][: hyp_lens[i]], id2tok,
                                         eos_id=model.eos)
                fout.write(f"{key} {text}\n")
                if ts_out is not None:
                    n = int(hyp_lens[i])
                    toks = [id2tok.get(int(t), "<unk>") for t in hyps[i][:n]]
                    ts_out.write(json.dumps(
                        {"key": key, "tokens": toks,
                         "times_ms": [float(t * POS_MS)
                                      for t in times[i][:n]]},
                        ensure_ascii=False) + "\n")
            n_done += len(keys)
            logger.info("decoded %d utts", n_done)
    if ts_out is not None:
        ts_out.close()
        logger.info("wrote %s", args.timestamp_file)
    logger.info("wrote %s", args.result_file)


def _ngram_rescore(model, enc, enc_lens, nbest, nbest_lens, nbest_scores,
                   ngram, id2tok, args):
    """Attention + ctc rescoring plus the host n-gram's lm_weight * log10
    score (bos and eos) of each candidate, in float32 as the JAX entry
    point adds it. Returns numpy (hyps [B, L], lens [B], winner [B])."""
    b, k, _ = nbest.shape
    score = rescoring_scores(model, enc, enc_lens, nbest, nbest_lens,
                             nbest_scores, ctc_weight=args.ctc_weight,
                             reverse_weight=args.reverse_weight)
    score = score.cpu().numpy().copy()
    nbest_np = nbest.cpu().numpy()
    lens_np = nbest_lens.cpu().numpy()
    for bi in range(b):
        for ki in range(k):
            toks = [id2tok.get(int(t), "<unk>")
                    for t in nbest_np[bi, ki][: int(lens_np[bi, ki])]]
            score[bi, ki] += args.lm_weight * ngram.score(
                " ".join(toks), bos=True, eos=True)
    best = score.argmax(axis=1)
    return (nbest_np[np.arange(b), best], lens_np[np.arange(b), best],
            best)


if __name__ == "__main__":
    main()
