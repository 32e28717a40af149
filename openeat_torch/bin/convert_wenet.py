"""Convert a WeNet / reference PyTorch .pt checkpoint for openeat_torch.
Port of openeat_tpu/bin/convert_wenet.py.

    python -m openeat_torch.bin.convert_wenet --pt final.pt --d_model 256 \\
        --out exp/wenet_import/converted [--wenet_config train.yaml]

writes the port's checkpoint `<out>.pt` (with its info `<out>.json`),
which `openeat_torch.bin.train --checkpoint` fine-tunes from (e.g. with
--only_adapter) and `openeat_torch.bin.recognize` decodes; with
--wenet_config, the release's train.yaml adapted to the framework's
layout (utils/wenet_convert.py:convert_wenet_config) as `train.json`
beside it. The conversion runs on the host; no device is used.
"""

from __future__ import annotations

import argparse
import json
import os

from openeat_torch.config import load_config
from openeat_torch.utils import checkpoint as ckpt_lib
from openeat_torch.utils.common import init_logger
from openeat_torch.utils.wenet_convert import (convert_wenet_config,
                                               is_wenet_config,
                                               load_wenet_checkpoint)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="convert a WeNet .pt "
                                            "checkpoint (PyTorch port)")
    p.add_argument("--pt", required=True, help="WeNet checkpoint path")
    p.add_argument("--d_model", type=int, default=256)
    p.add_argument("--out", required=True,
                   help="output checkpoint path without the .pt suffix")
    p.add_argument("--wenet_config", default=None,
                   help="the release's train.yaml; when given, an adapted "
                        "train.json is written next to --out")
    return p


def main(argv=None) -> str:
    """Returns the written checkpoint's path."""
    args = get_parser().parse_args(argv)
    logger = init_logger()
    state = load_wenet_checkpoint(args.pt, args.d_model)
    out_dir, tag = os.path.split(os.path.abspath(args.out))
    path = ckpt_lib.save_checkpoint(out_dir, tag, state,
                                    {"source": args.pt,
                                     "tensors": len(state)})
    logger.info("converted %d tensors -> %s", len(state), path)
    if args.wenet_config:
        wcfg = load_config(args.wenet_config)
        cfg = convert_wenet_config(wcfg) if is_wenet_config(wcfg) else wcfg
        conf_path = os.path.join(out_dir, "train.json")
        with open(conf_path, "w") as f:
            json.dump(cfg, f, indent=1)
        logger.info("adapted config -> %s", conf_path)
    return path


if __name__ == "__main__":
    main()
