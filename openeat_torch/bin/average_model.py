"""Checkpoint averaging entry point (PyTorch). Port of
openeat_tpu/bin/average_model.py, with its flags.

    python -m openeat_torch.bin.average_model --exp_dir exp --dst avg_5 \
        --num 5 --val_best

Averages the N best epoch_N.pt of exp_dir by the cv_loss in their
epoch_N.json (--val_best), or the last N of [--min_epoch, --max_epoch],
and writes <exp_dir>/<dst>.pt with <dst>.json {"averaged", "val_best"};
recognize and train --checkpoint read it like any epoch checkpoint.
Runs on the CPU: it only reads and writes state_dicts.
"""

from __future__ import annotations

import argparse

from openeat_torch.utils import checkpoint as ckpt_lib
from openeat_torch.utils.common import init_logger


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="average checkpoints (PyTorch)")
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--dst", required=True,
                   help="output checkpoint name (e.g. avg_best5)")
    p.add_argument("--num", type=int, default=5)
    p.add_argument("--val_best", action="store_true")
    p.add_argument("--min_epoch", type=int, default=0)
    p.add_argument("--max_epoch", type=int, default=10 ** 9)
    return p


def main(argv=None) -> str:
    args = get_parser().parse_args(argv)
    logger = init_logger()
    avg = ckpt_lib.average_checkpoints(args.exp_dir, args.num, args.val_best,
                                       args.min_epoch, args.max_epoch)
    path = ckpt_lib.save_checkpoint(
        args.exp_dir, args.dst, avg,
        {"averaged": args.num, "val_best": bool(args.val_best)})
    logger.info("wrote %s", path)
    return path


if __name__ == "__main__":
    main()
