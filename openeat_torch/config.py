"""Config loading. Port of openeat_tpu/config.py:load_config.

JSON is read with the standard library. YAML needs PyYAML, which is
imported only when a `.yaml`/`.yml` file is given, so a host without it
can still run from a JSON config.
"""

from __future__ import annotations

import json


def load_config(path: str) -> dict:
    """Load a JSON or YAML config file into a plain nested dict."""
    with open(path, "r", encoding="utf-8") as f:
        if path.endswith(".json"):
            return json.load(f) or {}
        if path.endswith((".yaml", ".yml")):
            import yaml
            return yaml.safe_load(f) or {}
    raise ValueError(f"{path}: config must be .json, .yaml or .yml")
