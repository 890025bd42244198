"""Run configs (counterpart of ``opentransformer_tpu/config.py``).

A config has the JAX package's three sections, ``data``, ``model`` and
``train``, with the same keys, but the port reads it from JSON: the
machine with the card has no ``pyyaml``. ``conf/transformer_baseline.json``,
``conformer_baseline.json`` and ``conformer_streaming.json`` are the
``egs/aishell/conf/`` YAMLs of those names with ``data.extract_on_device:
true`` added. ``set_key`` sets one key of a config from ``SECTION.KEY=VALUE``:
the recipes' edits (``tools/torch_edit_config.py``) and the measuring
tools' model variants both go through it.
"""

from __future__ import annotations

import json
import os

CONF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conf")


def load_config(path: str) -> dict:
    if path.endswith((".yaml", ".yml")):
        raise ValueError(f"{path}: the port reads JSON configs (no pyyaml on the card); "
                         "write the same sections as JSON, as in "
                         "opentransformer_tpu_torch/conf/transformer_baseline.json")
    with open(path, "r", encoding="utf-8") as f:
        cfg = json.load(f)
    if not isinstance(cfg, dict) or not {"data", "model", "train"} <= set(cfg):
        raise ValueError(f"{path}: a config needs the sections data, model and train")
    return cfg


def set_key(cfg: dict, assignment: str) -> None:
    """Set ``cfg[SECTION][KEY]...`` from ``"SECTION.KEY[.KEY...]=VALUE"`` in
    place (VALUE read as JSON, else kept as a string)."""
    path, eq, raw = assignment.partition("=")
    if not path or not eq:
        raise ValueError(f"a key wants SECTION.KEY=VALUE, got {assignment!r}")
    try:
        value = json.loads(raw)
    except json.JSONDecodeError:
        value = raw
    keys = path.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value
