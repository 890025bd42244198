#!/usr/bin/env python
"""Export a checkpoint of the PyTorch/CUDA port to the reference
OpenTransformer ``.pt`` layout (component state dicts and the config, as
the reference's ``eval.py`` loads them; an LM as ``{params, model}``).

    python tools/torch_export_reference.py CHECKPOINT OUT.pt [--model_cfg CFG.json]

``CHECKPOINT`` is an expdir (its newest ``model.epoch.N``), a checkpoint
directory with its run's ``config.json`` beside it, or an npz with
``--model_cfg`` (a JSON model config, an export manifest with a
``model_cfg`` key, or a run's config.json), such as
``egs/synth_bench/trained/anchor_synth_f16.npz`` with its manifest. The
model is built and loaded strictly before export. Covered: speech2text
with a transformer or ``ref_compat`` BatchNorm conformer encoder (with or
without a CTC head), and both LMs; anything else raises. It runs on the
CUDA card unless ``--device cpu`` is given.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from opentransformer_tpu_torch import compat  # noqa: E402
from opentransformer_tpu_torch.cli.eval import (  # noqa: E402
    load_checkpoint,
    load_model_cfg,
    load_weights,
)
from opentransformer_tpu_torch.models.registry import build_model  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Export a port checkpoint to a reference .pt")
    p.add_argument("checkpoint", help="expdir, checkpoint directory or npz")
    p.add_argument("out", help="output .pt path")
    p.add_argument("--model_cfg", default=None,
                   help="model config for an npz (or to override the run's)")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    state, cfg = load_checkpoint(args.checkpoint)
    if args.model_cfg:
        cfg = dict(cfg or {}, model=load_model_cfg(args.model_cfg))
    if not cfg or "model" not in cfg:
        raise SystemExit(f"error: no config comes with {args.checkpoint}; pass --model_cfg")
    model = load_weights(build_model(cfg["model"], device=args.device), state)
    chkpt = compat.export_reference_checkpoint(model, json.loads(json.dumps(cfg)))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(chkpt, args.out)
    print(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
