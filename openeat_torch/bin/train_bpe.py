"""Train the BPE tokenizer (host). Port of openeat_tpu/bin/train_bpe.py,
with the same flags and outputs:

    python -m openeat_torch.bin.train_bpe --input text --skip_ncols 1 \
        --model_prefix data/bpe_1000 --vocab_size 1000

writes `<prefix>.bpe.json` (the model, which --bpe_model of train,
train_lm, recognize and text2token reads, in either package) and
`<prefix>.vocab` (one symbol a line), and prints the model's path.
"""

from __future__ import annotations

import argparse

from openeat_torch.dataset.bpe import train_bpe


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train BPE model")
    p.add_argument("--input", required=True, help="text file, one line each")
    p.add_argument("--model_prefix", required=True)
    p.add_argument("--vocab_size", type=int, default=1000)
    p.add_argument("--skip_ncols", type=int, default=0)
    return p


def main(argv=None) -> str:
    args = get_parser().parse_args(argv)
    lines = []
    with open(args.input, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(None, args.skip_ncols)
            lines.append(parts[args.skip_ncols]
                         if len(parts) > args.skip_ncols else "")
    model = train_bpe(lines, args.vocab_size)
    path = args.model_prefix + ".bpe.json"
    model.save(path)
    with open(args.model_prefix + ".vocab", "w", encoding="utf-8") as f:
        for tok in model.vocab:
            f.write(tok + "\n")
    print(path)
    return path


if __name__ == "__main__":
    main()
