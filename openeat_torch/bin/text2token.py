"""Text -> token stream (host). Port of openeat_tpu/bin/text2token.py,
with the same flags and output: reads `<utt> <text>` lines (a file or
stdin), strips punctuation and writes `<utt> <tok1> <tok2> ...` with the
CJK + BPE tokenizer of openeat_torch/dataset/text.py, as recipes do to
build the dict:

    python -m openeat_torch.bin.text2token data/train/text \
        --bpe_model data/bpe_1000.bpe.json
"""

from __future__ import annotations

import argparse
import sys

from openeat_torch.dataset.bpe import load_bpe
from openeat_torch.dataset.text import remove_punctuation, tokenize


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tokenize text")
    p.add_argument("text", nargs="?", default=None,
                   help="input file (default stdin)")
    p.add_argument("--bpe_model", default=None)
    p.add_argument("--skip_ncols", type=int, default=1,
                   help="leading columns (utt ids) to pass through")
    return p


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    bpe = load_bpe(args.bpe_model)
    fin = open(args.text, encoding="utf-8") if args.text else sys.stdin
    try:
        for line in fin:
            parts = line.rstrip("\n").split(None, args.skip_ncols)
            head = parts[: args.skip_ncols]
            text = (parts[args.skip_ncols] if len(parts) > args.skip_ncols
                    else "")
            print(" ".join(head + tokenize(remove_punctuation(text), bpe)))
    finally:
        if args.text:
            fin.close()


if __name__ == "__main__":
    main()
