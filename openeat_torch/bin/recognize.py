"""Offline decoding entry point (PyTorch).

Port of openeat_tpu/bin/recognize.py: reads a manifest, extracts
features on the device, encodes whole batches and decodes them with
ctc_greedy_search, ctc_prefix_beam_search, attention (the KV-cached
beam search; --adaptive_steps bounds its steps by the CTC greedy
lengths, --length_penalty adds a per-token bonus at the final pick) or
attention_rescoring, and writes `<utt> <text>` lines. The flags are the
JAX entry point's, plus --device (default cuda; cpu must be asked for).

--checkpoint takes the port's own state_dict (.pt; a WeNet release
after openeat_torch.bin.convert_wenet) or an .npz of flax leaves as
openeat_tpu/utils/checkpoint.py:_flatten keys them, converted through
openeat_torch/utils/param_bridge.py; so does --lm_checkpoint. A
WeNet-layout --config (encoder_conf / decoder_conf) is adapted as the
JAX entry point adapts it (utils/wenet_convert.py:convert_wenet_config;
raw fbank into the checkpoint's global CMVN), its vocab from the dict
when it has no output_dim. Whether the model has global CMVN is read
from the checkpoint; a config that says otherwise is an error.
With --lm_weight > 0, attention_rescoring fuses a Transformer LM
(--lm_config, --lm_checkpoint; on the device) or an ARPA/binary n-gram
(--ngram_lm; on the host). --timestamp_file writes JSONL {key, tokens,
times_ms} of the CTC emission onsets (one encoder position = subsampling
rate x 10 ms) in the CTC-alignment modes. --quantize int8 decodes with
int8 weight-only Dense weights (utils/quantize.py).

--dp N (-1: every rank) decodes under torchrun, one process per rank
(openeat_torch/parallel/mesh.py): every batch is padded to --batch_size,
which must be a multiple of N, as the JAX entry point pads and shards
it; rank r decodes rows [r*B/N, (r+1)*B/N), a mixture-of-experts
encoder routing with the global batch's capacity, and the first rank
gathers the rows and writes the result and timestamp files, the same
bytes as --dp 1.

--bpe_model tokenizes the references with a BPE model, and the written
text re-joins the `▁` pieces into words; a wav.scp entry may be WAV or
FLAC; --data_type feat (or kaldi) decodes precomputed kaldi ark
features, through the frontend's feature-level tail only.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from openeat_torch.config import load_config
from openeat_torch.dataset.bpe import load_bpe
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
from openeat_torch.parallel.mesh import apply_mesh, close_mesh, init_mesh
from openeat_torch.pipeline import DeviceFeeder
from openeat_torch.utils.common import init_logger, resolve_device
from openeat_torch.utils.param_bridge import flax_to_state_dict
from openeat_torch.utils.quantize import quantize_model, quantized_bytes
from openeat_torch.utils.wenet_convert import (convert_wenet_config,
                                               is_wenet_config)

MODES = ["ctc_greedy_search", "ctc_prefix_beam_search", "attention",
         "attention_rescoring"]


def position_ms(model: ASRModel) -> float:
    """ms of audio per encoder position: 10 ms frames through the input
    layer's subsampling."""
    return 10.0 * model.encoder.embed.subsampling_rate


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
    if is_wenet_config(cfg):
        cfg = convert_wenet_config(cfg)
    want_times = args.timestamp_file is not None
    if want_times and args.mode == "attention":
        raise SystemExit("--timestamp_file needs a CTC frame alignment; "
                         "the attention mode has none (use "
                         "ctc_greedy_search / ctc_prefix_beam_search / "
                         "attention_rescoring)")
    device = resolve_device(args.device)
    mesh, device = init_mesh(args.dp, 1, device)
    try:
        if mesh is not None and args.batch_size % mesh.dp:
            raise ValueError(f"--batch_size {args.batch_size} must be a "
                             f"multiple of --dp {mesh.dp}")
        _decode(args, cfg, device, mesh, logger)
    finally:
        close_mesh(mesh)


def _decode(args, cfg: dict, device: torch.device, mesh, logger) -> None:
    want_times = args.timestamp_file is not None
    char_dict = load_dict(args.dict_path)
    model = load_model(cfg, args.checkpoint, len(char_dict), device,
                       args.quantize)
    apply_mesh(model, mesh)
    id2tok = {v: k for k, v in char_dict.items()}
    collate_conf = dict(cfg.get("collate_conf", {}) or {})
    fe_conf = collate_conf.get("feature_extraction_conf", {}) or {}
    dataset_conf = dict(cfg.get("dataset_conf", {}) or {})
    test_ds = AudioDataset(
        args.test_data, char_dict, load_bpe(args.bpe_model),
        max_length=dataset_conf.get("max_length", 10240),
        min_length=dataset_conf.get("min_length", 0),
        token_max_length=dataset_conf.get("token_max_length", 200),
        batch_size=args.batch_size, sort=True,
        data_type="wav" if args.data_type == "wav" else "feat")
    collate = AudioCollate(resample_rate=fe_conf.get("resample_rate", 16000))
    frontend = FrontendConfig.from_collate_conf(
        collate_conf).without_augmentation()
    feeder = DeviceFeeder(PrefetchLoader(test_ds, collate, num_workers=4),
                          frontend, device,
                          pad_batch_multiple=args.batch_size, mesh=mesh)

    lm_logp_fn, lm_style, ngram = None, "ar", None
    if args.lm_weight > 0 and args.lm_config and args.lm_checkpoint:
        lm = load_language_model(load_config(args.lm_config),
                                 args.lm_checkpoint, len(char_dict), device)
        lm_style = "ar" if lm.autoregressive else "mlm"
        lm_logp_fn = lm.log_probs if lm.autoregressive else lm.mlm_log_probs
    elif args.lm_weight > 0 and args.ngram_lm:
        ngram = load_lm(args.ngram_lm)

    writer = mesh is None or dist.get_rank() == 0
    fout = ts_out = None
    if writer:
        os.makedirs(os.path.dirname(os.path.abspath(args.result_file)),
                    exist_ok=True)
        fout = open(args.result_file, "w", encoding="utf-8")
        if want_times:
            ts_out = open(args.timestamp_file, "w", encoding="utf-8")
    pos_ms = position_ms(model)
    n_done = 0
    try:
        with torch.inference_mode():
            for keys, batch in feeder:
                rows = _decode_rows(model, batch, args, lm_logp_fn,
                                    lm_style, ngram, id2tok)
                if mesh is not None:
                    parts = [None] * mesh.dp
                    dist.all_gather_object(parts, rows,
                                           group=mesh.data_group)
                    rows = [r for part in parts for r in part]
                n_done += len(keys)
                if not writer:
                    continue
                for key, (toks, times) in zip(keys, rows):
                    text = token_ids_to_text(toks, id2tok, eos_id=model.eos)
                    fout.write(f"{key} {text}\n")
                    if ts_out is not None:
                        ts_out.write(json.dumps(
                            {"key": key,
                             "tokens": [id2tok.get(t, "<unk>")
                                        for t in toks],
                             "times_ms": [float(t * pos_ms) for t in times]},
                            ensure_ascii=False) + "\n")
                logger.info("decoded %d utts", n_done)
    finally:
        for f in (fout, ts_out):
            if f is not None:
                f.close()
    if ts_out is not None:
        logger.info("wrote %s", args.timestamp_file)
    if writer:
        logger.info("wrote %s", args.result_file)


def _decode_rows(model, batch, args, lm_logp_fn, lm_style, ngram,
                 id2tok) -> list[tuple[list[int], list]]:
    """Decode one batch; (token ids, CTC times or []) per row."""
    want_times = args.timestamp_file is not None
    enc, enc_lens = model.encode(batch["features"], batch["features_length"])
    times = None
    if args.mode == "attention":
        max_steps = min(int(enc.shape[1]), args.max_hyp_len)
        if args.adaptive_steps:
            _, glens = ctc_greedy_search(model.ctc_log_probs(enc), enc_lens)
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
            model.ctc_log_probs(enc), enc_lens, beam_size=args.beam_size,
            max_hyp_len=args.max_hyp_len, return_times=want_times)
        nbest, nbest_lens, nbest_scores = out[:3]
        if args.mode == "ctc_prefix_beam_search":
            win = torch.zeros(len(nbest), dtype=torch.long)
            hyps, hyp_lens = nbest[:, 0], nbest_lens[:, 0]
        elif ngram is not None:
            hyps, hyp_lens, win = _ngram_rescore(
                model, enc, enc_lens, nbest, nbest_lens, nbest_scores, ngram,
                id2tok, args)
        else:
            hyps, hyp_lens, _, win = attention_rescoring(
                model, enc, enc_lens, nbest, nbest_lens, nbest_scores,
                ctc_weight=args.ctc_weight,
                reverse_weight=args.reverse_weight, lm_logp_fn=lm_logp_fn,
                lm_weight=args.lm_weight if lm_logp_fn else 0.0,
                lm_style=lm_style)
        if want_times:
            times = out[3].cpu()[torch.arange(len(nbest)),
                                 torch.as_tensor(win).cpu()]
    hyps = torch.as_tensor(hyps).cpu().numpy()
    hyp_lens = torch.as_tensor(hyp_lens).cpu().numpy()
    if times is not None:
        times = times.cpu().numpy()
    return [([int(t) for t in hyps[i][: hyp_lens[i]]],
             [] if times is None else times[i][: hyp_lens[i]].tolist())
            for i in range(len(hyps))]


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
