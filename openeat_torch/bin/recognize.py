"""Offline decoding entry point (PyTorch).

Port of openeat_tpu/bin/recognize.py: reads a manifest, extracts
features on the device, encodes whole batches and decodes them with
ctc_greedy_search, ctc_prefix_beam_search or attention_rescoring, and
writes `<utt> <text>` lines. The flags are the JAX entry point's, plus
--device (default cuda; cpu must be asked for).

--checkpoint takes the port's own state_dict (.pt) or an .npz of flax
leaves as openeat_tpu/utils/checkpoint.py:_flatten keys them, converted
through openeat_torch/utils/param_bridge.py.

Not ported yet, refused with NotImplementedError: --mode attention,
--timestamp_file, --quantize int8, --dp other than 1, LM fusion,
--bpe_model, --data_type feat/kaldi and WeNet-layout configs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from openeat_torch.config import load_config
from openeat_torch.dataset.dataset import (AudioCollate, AudioDataset,
                                           PrefetchLoader)
from openeat_torch.dataset.text import load_dict, token_ids_to_text
from openeat_torch.decode.ctc_greedy import ctc_greedy_search
from openeat_torch.decode.ctc_prefix_beam import ctc_prefix_beam_search
from openeat_torch.decode.rescoring import attention_rescoring
from openeat_torch.models.asr_model import ASRModel, build_asr_model
from openeat_torch.ops.frontend import FrontendConfig
from openeat_torch.pipeline import DeviceFeeder
from openeat_torch.utils.common import init_logger, resolve_device
from openeat_torch.utils.param_bridge import flax_to_state_dict

MODES = ["ctc_greedy_search", "ctc_prefix_beam_search", "attention",
         "attention_rescoring"]


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
    p.add_argument("--quantize", default="none", choices=["none", "int8"])
    p.add_argument("--timestamp_file", default=None)
    p.add_argument("--dp", type=int, default=1)
    return p


def refuse_unported(args, cfg: dict) -> None:
    """Raise NotImplementedError for what this port does not do yet."""
    later = {
        "--mode attention": (args.mode == "attention",
                             "the attention-decode slice (KV-cache "
                             "forward_step)"),
        "--timestamp_file": (args.timestamp_file is not None,
                             "a later decode slice"),
        "--quantize int8": (args.quantize != "none", "the int8 slice"),
        "--dp": (args.dp != 1, "the parallel-layout slice"),
        "LM fusion": (args.lm_weight > 0 or bool(args.lm_config)
                      or bool(args.lm_checkpoint) or bool(args.ngram_lm),
                      "the LM slice"),
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


def load_model(cfg: dict, checkpoint: str, vocab_size: int,
               device: torch.device) -> ASRModel:
    """Build the model from `cfg` and fill it from `checkpoint`. Whether
    the encoder has global CMVN is read from the checkpoint; a config
    that says otherwise is an error."""
    if checkpoint.endswith(".npz"):
        with np.load(checkpoint) as z:
            flat = {k: z[k] for k in z.files}
        has_cmvn = "params/encoder/global_cmvn/mean" in flat
    else:
        state = torch.load(checkpoint, map_location="cpu", weights_only=True)
        has_cmvn = "encoder.global_cmvn.mean" in state
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
        state = flax_to_state_dict(flat, model)
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def main(argv=None):
    args = get_parser().parse_args(argv)
    logger = init_logger()
    cfg = load_config(args.config)
    refuse_unported(args, cfg)
    device = resolve_device(args.device)
    char_dict = load_dict(args.dict_path)
    model = load_model(cfg, args.checkpoint, len(char_dict), device)
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

    n_done = 0
    os.makedirs(os.path.dirname(os.path.abspath(args.result_file)),
                exist_ok=True)
    with open(args.result_file, "w", encoding="utf-8") as fout, \
            torch.inference_mode():
        for keys, batch in feeder:
            enc, enc_lens = model.encode(batch["features"],
                                         batch["features_length"])
            ctc_logp = model.ctc_log_probs(enc)
            if args.mode == "ctc_greedy_search":
                hyps, hyp_lens = ctc_greedy_search(ctc_logp, enc_lens)
            else:
                nbest, nbest_lens, nbest_scores = ctc_prefix_beam_search(
                    ctc_logp, enc_lens, beam_size=args.beam_size,
                    max_hyp_len=args.max_hyp_len)
                if args.mode == "ctc_prefix_beam_search":
                    hyps, hyp_lens = nbest[:, 0], nbest_lens[:, 0]
                else:
                    hyps, hyp_lens, _, _ = attention_rescoring(
                        model, enc, enc_lens, nbest, nbest_lens,
                        nbest_scores, ctc_weight=args.ctc_weight,
                        reverse_weight=args.reverse_weight)
            hyps = hyps.cpu().numpy()
            hyp_lens = hyp_lens.cpu().numpy()
            for i, key in enumerate(keys):
                text = token_ids_to_text(hyps[i][: hyp_lens[i]], id2tok,
                                         eos_id=model.eos)
                fout.write(f"{key} {text}\n")
            n_done += len(keys)
            logger.info("decoded %d utts", n_done)
    logger.info("wrote %s", args.result_file)


if __name__ == "__main__":
    main()
