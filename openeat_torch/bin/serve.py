"""Streaming ASR server entry point (PyTorch).

Port of openeat_tpu/bin/serve.py: serves a trained causal, chunked
model over the framed TCP protocol of openeat_torch/runtime/server.py,
batching up to --slots concurrent sessions per chunk step. The flags are
the JAX entry point's, plus --device (default cuda; cpu must be asked
for); --checkpoint takes a .pt state_dict or an .npz of flax leaves, as
openeat_torch.bin.recognize does. A model trained with per-utterance
feature normalisation is served with the causal "running" one.

    python -m openeat_torch.bin.serve \
        --config exp/train.json --checkpoint exp/avg_5.pt \
        --dict data/dict.txt --port 8990 --slots 16
"""

from __future__ import annotations

import argparse

from openeat_torch.bin.recognize import load_model
from openeat_torch.config import load_config
from openeat_torch.dataset.text import load_dict
from openeat_torch.decode.endpoint import EndpointConfig
from openeat_torch.runtime.server import AsrServer
from openeat_torch.utils.common import init_logger, resolve_device


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="streaming ASR server "
                                            "(PyTorch)")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="port state_dict (.pt) or flax leaves (.npz)")
    p.add_argument("--dict", dest="dict_path", required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a CUDA "
                        "device raises")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8990)
    p.add_argument("--slots", type=int, default=8,
                   help="concurrent sessions per chunk step; further "
                        "connections queue for admission")
    p.add_argument("--chunk_size", type=int, default=16)
    p.add_argument("--num_left_chunks", type=int, default=4)
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--final_mode", default="attention_rescoring",
                   choices=["ctc_greedy_search", "attention_rescoring"])
    p.add_argument("--beam_size", type=int, default=10)
    p.add_argument("--ctc_weight", type=float, default=0.5)
    p.add_argument("--reverse_weight", type=float, default=0.0)
    p.add_argument("--max_hyp_len", type=int, default=64)
    p.add_argument("--enc_capacity", type=int, default=512)
    p.add_argument("--quantize", default="none", choices=["none", "int8"],
                   help="int8 weight-only quantization (utils/quantize.py)")
    p.add_argument("--endpoint", action="store_true",
                   help="finalize a stream server-side when the greedy "
                        "CTC path meets the trailing-silence rules "
                        "(decode/endpoint.py); the final event carries "
                        "endpoint: true")
    p.add_argument("--endpoint_rule1_ms", type=float, default=5000.0,
                   help="trailing silence (ms) ending a stream that "
                        "never produced a token")
    p.add_argument("--endpoint_rule2_ms", type=float, default=1000.0,
                   help="trailing silence (ms) ending a stream after "
                        "speech")
    p.add_argument("--endpoint_rule3_ms", type=float, default=20000.0,
                   help="maximum utterance length (ms) before a forced "
                        "endpoint")
    return p


def build_server(args) -> AsrServer:
    cfg = load_config(args.config)
    device = resolve_device(args.device)
    char_dict = load_dict(args.dict_path)
    model = load_model(cfg, args.checkpoint, len(char_dict), device,
                       args.quantize)
    per_utt = (cfg.get("collate_conf", {}) or {}).get("normalization", True)
    ep_conf = None
    if args.endpoint:
        ep_conf = EndpointConfig(
            rule1_min_trailing_silence=args.endpoint_rule1_ms,
            rule2_min_trailing_silence=args.endpoint_rule2_ms,
            rule3_min_utterance_length=args.endpoint_rule3_ms)
    return AsrServer(
        model, char_dict, host=args.host, port=args.port, slots=args.slots,
        chunk_size=args.chunk_size, num_left_chunks=args.num_left_chunks,
        sample_rate=args.sample_rate,
        normalization="running" if per_utt else "none",
        beam_size=args.beam_size, max_hyp_len=args.max_hyp_len,
        enc_capacity=args.enc_capacity, ctc_weight=args.ctc_weight,
        reverse_weight=args.reverse_weight, final_mode=args.final_mode,
        endpoint=args.endpoint, endpoint_config=ep_conf)


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    logger = init_logger()
    server = build_server(args)
    logger.info("serving on %s:%d (%d slots, final=%s, device %s)",
                server.addr[0], server.addr[1], args.slots, args.final_mode,
                args.device)
    server.serve_forever()


if __name__ == "__main__":
    main()
