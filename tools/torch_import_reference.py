#!/usr/bin/env python
"""Convert a reference OpenTransformer checkpoint (``model.epoch.N.pt``, a
speech2text model's or an LM's) into a checkpoint directory of the
PyTorch/CUDA port.

    python tools/torch_import_reference.py model.epoch.N.pt OUT_EXPDIR [-c CONF.json]

Writes ``OUT_EXPDIR/model.imported/params.npz`` (float32, the JAX package's
naming, as ``cli/run.py`` writes it) and ``OUT_EXPDIR/config.json``: the
config embedded in the file, or ``-c``'s. The model is built from that
config and loaded strictly, so a file that does not fit it fails here; the
eval CLI then decodes ``-m OUT_EXPDIR/model.imported``. It runs on the CUDA
card unless ``--device cpu`` is given.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from opentransformer_tpu_torch import compat  # noqa: E402
from opentransformer_tpu_torch.cli.eval import load_weights  # noqa: E402
from opentransformer_tpu_torch.config import load_config  # noqa: E402
from opentransformer_tpu_torch.models.registry import build_model  # noqa: E402
from opentransformer_tpu_torch.train.checkpoint import Checkpointer  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Import a reference .pt checkpoint")
    p.add_argument("pt", help="reference model.epoch.N.pt")
    p.add_argument("expdir", help="output experiment directory")
    p.add_argument("-c", "--config", default=None,
                   help="JSON run config (default: the one embedded in the .pt)")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    cfg = load_config(args.config) if args.config else None
    state, embedded = compat.load_reference_any(args.pt, cfg["model"] if cfg else None)
    cfg = cfg or embedded
    if not cfg:
        raise SystemExit(f"error: {args.pt} embeds no config; pass -c")
    model_cfg = cfg.get("model", cfg)
    model = load_weights(build_model(model_cfg, device=args.device), state)
    ck = Checkpointer(args.expdir, config=cfg if "model" in cfg else {"model": cfg})
    print(ck.save_params_only("model.imported", model))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
