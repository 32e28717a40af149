"""Simulated-streaming decode entry point (PyTorch).

Port of openeat_tpu/bin/stream_recognize.py: feeds each utterance of a
manifest to the online recognizer in real-time-sized pieces and writes
`<utt> <text>` lines, and with --timestamp_file JSONL {key, tokens,
times_ms} of the CTC emission onsets (40 ms granularity). The flags are
the JAX entry point's, plus --device (default cuda; cpu must be asked
for); --checkpoint takes a .pt state_dict or an .npz of flax leaves, as
openeat_torch.bin.recognize does.

Routing, as in the JAX entry point: --slots 1 with --final_mode
ctc_greedy_search runs the single-stream StreamingRecognizer and logs
the p50 and p99 of each utterance's longest piece latency; more slots,
or attention_rescoring finals at any slot count, run StreamingBatch with
the utterances as concurrent streams fed round-robin, and log the
aggregate x-realtime. A model trained with per-utterance feature
normalisation is fed the causal "running" normalisation. --quantize
int8 streams with int8 weight-only Dense weights (utils/quantize.py).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from openeat_torch.bin.recognize import load_model
from openeat_torch.config import load_config
from openeat_torch.dataset.audio import read_wav, resample
from openeat_torch.dataset.manifest import parse_manifest, parse_wav_entry
from openeat_torch.dataset.text import load_dict, token_ids_to_text
from openeat_torch.decode.streaming import StreamingRecognizer
from openeat_torch.decode.streaming_batch import StreamingBatch
from openeat_torch.utils.common import init_logger, resolve_device


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="streaming decode (PyTorch)")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="port state_dict (.pt) or flax leaves (.npz)")
    p.add_argument("--test_data", required=True)
    p.add_argument("--dict", dest="dict_path", required=True)
    p.add_argument("--result_file", required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a CUDA "
                        "device raises")
    p.add_argument("--chunk_size", type=int, default=16,
                   help="encoder chunk in subsampled frames (16 = 640 ms)")
    p.add_argument("--num_left_chunks", type=int, default=4)
    p.add_argument("--piece_ms", type=int, default=200,
                   help="audio arrives in pieces of this duration")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--slots", type=int, default=1,
                   help=">1: decode the manifest as this many concurrent "
                        "streams of the batched runtime")
    p.add_argument("--final_mode", default="attention_rescoring",
                   choices=["ctc_greedy_search", "attention_rescoring"])
    p.add_argument("--beam_size", type=int, default=10)
    p.add_argument("--ctc_weight", type=float, default=0.5)
    p.add_argument("--reverse_weight", type=float, default=0.0)
    p.add_argument("--max_hyp_len", type=int, default=64)
    p.add_argument("--enc_capacity", type=int, default=512,
                   help="encoder rows kept per stream for the rescoring")
    p.add_argument("--quantize", default="none", choices=["none", "int8"],
                   help="int8 weight-only quantization (utils/quantize.py)")
    p.add_argument("--timestamp_file", default=None)
    return p


def _write_times(ts_out, key, tok_ids, times_ms, id2tok) -> None:
    ts_out.write(json.dumps(
        {"key": key,
         "tokens": [id2tok.get(int(t), "<unk>") for t in tok_ids],
         "times_ms": [float(t) for t in times_ms]},
        ensure_ascii=False) + "\n")


def _read(u, sample_rate: int) -> np.ndarray:
    path, start, end = parse_wav_entry(u.path)
    wav, rate = read_wav(path, start, end)
    if rate != sample_rate:
        wav = resample(wav, rate, sample_rate)
    return wav * 32768.0


def main(argv=None) -> dict:
    """Decode the manifest; returns the run's figures (utts, audio_s,
    wall_s, and the piece latencies or the aggregate x-realtime)."""
    args = get_parser().parse_args(argv)
    logger = init_logger()
    cfg = load_config(args.config)
    device = resolve_device(args.device)
    char_dict = load_dict(args.dict_path)
    model = load_model(cfg, args.checkpoint, len(char_dict), device,
                       args.quantize)
    id2tok = {v: k for k, v in char_dict.items()}
    utts = parse_manifest(args.test_data, char_dict, max_length=10 ** 9,
                          sort=False)
    per_utt = (cfg.get("collate_conf", {}) or {}).get("normalization", True)
    norm = "running" if per_utt else "none"
    if per_utt:
        logger.warning("model was trained with per-utterance feature "
                       "normalization; streaming uses the causal running "
                       "normalization (approximate)")
    os.makedirs(os.path.dirname(os.path.abspath(args.result_file)),
                exist_ok=True)
    if args.slots > 1 or args.final_mode == "attention_rescoring":
        return _run_batched(args, logger, model, utts, id2tok, norm)
    piece = int(args.sample_rate * args.piece_ms / 1000)
    lat, worst = [], []
    audio_s = 0.0
    t0 = time.perf_counter()
    ts_out = (open(args.timestamp_file, "w", encoding="utf-8")
              if args.timestamp_file else None)
    try:
        with open(args.result_file, "w", encoding="utf-8") as fout:
            for u in utts:
                wav = _read(u, args.sample_rate)
                audio_s += len(wav) / args.sample_rate
                sr = StreamingRecognizer(
                    model, chunk_size=args.chunk_size,
                    num_left_chunks=args.num_left_chunks,
                    sample_rate=args.sample_rate, normalization=norm)
                t_max = 0.0
                for i in range(0, len(wav), piece):
                    t1 = time.perf_counter()
                    sr.accept_waveform(wav[i: i + piece])
                    lat.append(time.perf_counter() - t1)
                    t_max = max(t_max, lat[-1])
                sr.finish()
                text = token_ids_to_text(sr.result(), id2tok)
                fout.write(f"{u.key} {text}\n")
                if ts_out is not None:
                    _write_times(ts_out, u.key, sr.result(),
                                 sr.result_times_ms(), id2tok)
                worst.append(t_max)
                logger.info("%s: '%s' (max piece latency %.1f ms)", u.key,
                            text, t_max * 1000)
    finally:
        if ts_out is not None:
            ts_out.close()
    wall = time.perf_counter() - t0
    logger.info("done: %d utts, p50 piece latency %.1f ms, p99 %.1f ms",
                len(worst), np.percentile(worst, 50) * 1000,
                np.percentile(worst, 99) * 1000)
    return {"utts": len(utts), "audio_s": audio_s, "wall_s": wall,
            "pieces": len(lat),
            "piece_latency_ms_p50": float(np.percentile(lat, 50) * 1000),
            "piece_latency_ms_p99": float(np.percentile(lat, 99) * 1000),
            "utt_max_piece_latency_ms_p50": float(
                np.percentile(worst, 50) * 1000),
            "utt_max_piece_latency_ms_p99": float(
                np.percentile(worst, 99) * 1000)}


def _run_batched(args, logger, model, utts, id2tok, norm) -> dict:
    """The utterances as concurrent streams: each takes a free slot,
    audio arrives round-robin in piece_ms pieces, and a stream is
    finished as soon as its audio is exhausted, the others riding
    along."""
    batch = StreamingBatch(
        model, slots=args.slots, chunk_size=args.chunk_size,
        num_left_chunks=args.num_left_chunks, sample_rate=args.sample_rate,
        normalization=norm, beam_size=args.beam_size,
        max_hyp_len=args.max_hyp_len, enc_capacity=args.enc_capacity)
    piece = int(args.sample_rate * args.piece_ms / 1000)
    rescore = args.final_mode == "attention_rescoring"
    pending = list(utts)
    live = []  # [handle, utt, wav, sample position]
    t0 = time.perf_counter()
    total_audio = 0.0
    results, times = {}, {}
    while pending or live:
        while pending and len(live) < args.slots:
            u = pending.pop(0)
            wav = _read(u, args.sample_rate)
            total_audio += len(wav) / args.sample_rate
            live.append([batch.open(), u, wav, 0])
        for ent in live:
            h, _, wav, pos = ent
            batch.accept(h, wav[pos: pos + piece])
            ent[3] = pos + piece
        batch.run_ready()
        still = []
        for ent in live:
            h, u, wav, pos = ent
            if pos < len(wav):
                still.append(ent)
                continue
            toks = batch.finish(h, rescore=rescore,
                                ctc_weight=args.ctc_weight,
                                reverse_weight=args.reverse_weight)
            times[u.key] = (list(toks), h.result_times_ms())
            batch.close(h)
            results[u.key] = token_ids_to_text(toks, id2tok)
            logger.info("%s: '%s'", u.key, results[u.key])
        live = still
    dt = time.perf_counter() - t0
    with open(args.result_file, "w", encoding="utf-8") as fout:
        for u in utts:
            fout.write(f"{u.key} {results[u.key]}\n")
    if args.timestamp_file:
        with open(args.timestamp_file, "w", encoding="utf-8") as ts_out:
            for u in utts:
                _write_times(ts_out, u.key, *times[u.key], id2tok)
    logger.info("done: %d utts over %d slots, %.1f audio-sec in %.1fs "
                "wall (%.1fx realtime aggregate)", len(utts), args.slots,
                total_audio, dt, total_audio / max(dt, 1e-9))
    return {"utts": len(utts), "slots": args.slots, "audio_s": total_audio,
            "wall_s": dt, "x_realtime": total_audio / max(dt, 1e-9)}


if __name__ == "__main__":
    main()
