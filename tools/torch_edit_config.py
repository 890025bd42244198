#!/usr/bin/env python
"""Write a copy of a JSON run config with keys set: the port's recipes'
counterpart of the ``sed`` and ``yaml`` edits of the JAX recipes.

    python tools/torch_edit_config.py IN.json OUT.json \\
        [--set train.epochs=3] [--set 'train.scheduler={"lr": 1e-4}'] [--data DIR]

``--set SECTION.KEY[.KEY...]=VALUE`` sets a key (VALUE read as JSON, else
kept as a string); ``--data DIR`` points the vocab and every split's
``feat`` and ``text`` at ``DIR/vocab``, ``DIR/<split>/feats.scp`` and
``DIR/<split>/text`` (a corpus of ``opentransformer_tpu_torch.data.synth``).
A host tool: it reads and writes files only (``config.set_key`` does the
setting).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from opentransformer_tpu_torch.config import set_key  # noqa: E402

SPLITS = ("train", "dev", "test")


def point_data(cfg: dict, root: str) -> None:
    data = cfg["data"]
    data["vocab"] = os.path.join(root, "vocab")
    for split in SPLITS:
        if split in data:
            data[split] = {"feat": [os.path.join(root, split, "feats.scp")],
                           "text": [os.path.join(root, split, "text")]}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Copy a JSON run config with keys set")
    p.add_argument("config", help="input JSON config")
    p.add_argument("out", help="output JSON config")
    p.add_argument("--set", action="append", default=[], metavar="KEY.PATH=VALUE")
    p.add_argument("--data", default=None, help="corpus root of the data section's paths")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    with open(args.config, "r", encoding="utf-8") as f:
        cfg = json.load(f)
    for assignment in args.set:
        try:
            set_key(cfg, assignment)
        except ValueError as e:
            raise SystemExit(f"error: --set: {e}") from None
    if args.data:
        point_data(cfg, args.data)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(cfg, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
