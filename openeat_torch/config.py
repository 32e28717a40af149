"""Config loading and the scalar training keys. Port of
openeat_tpu/config.py:load_config and TrainConfig.

JSON is read with the standard library. YAML needs PyYAML, which is
imported only when a `.yaml`/`.yml` file is given, so a host without it
can still run from a JSON config.
"""

from __future__ import annotations

import json
from dataclasses import dataclass


def load_config(path: str) -> dict:
    """Load a JSON or YAML config file into a plain nested dict."""
    with open(path, "r", encoding="utf-8") as f:
        if path.endswith(".json"):
            return json.load(f) or {}
        if path.endswith((".yaml", ".yml")):
            import yaml
            return yaml.safe_load(f) or {}
    raise ValueError(f"{path}: config must be .json, .yaml or .yml")


@dataclass
class TrainConfig:
    """Scalar training keys with the reference's defaults. Port of
    openeat_tpu/config.py:TrainConfig."""

    grad_clip: float = 5.0
    accum_grad: int = 1
    max_epoch: int = 50
    log_interval: int = 100
    optim: str = "adam"
    lr: float = 0.001
    warmup_epoch: float = 10.0
    warmup_steps: int | None = None  # overrides warmup_epoch if set
    seed: int = 777

    @classmethod
    def from_dict(cls, cfg: dict) -> "TrainConfig":
        optim_conf = cfg.get("optim_conf", {}) or {}
        return cls(
            grad_clip=cfg.get("grad_clip", 5.0),
            accum_grad=cfg.get("accum_grad", 1),
            max_epoch=cfg.get("max_epoch", 50),
            log_interval=cfg.get("log_interval", 100),
            optim=cfg.get("optim", "adam"),
            lr=optim_conf.get("lr", 0.001),
            warmup_epoch=cfg.get("warmup_epoch", 10.0),
            warmup_steps=cfg.get("warmup_steps"),
            seed=cfg.get("seed", 777),
        )
