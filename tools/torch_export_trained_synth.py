#!/usr/bin/env python
"""Export a trained checkpoint of the PyTorch/CUDA port (``cli/run.py`` or
``cli/average.py``: its ``params.npz``) in the format of
``tools/export_trained_synth.py``: the parameters alone, float16, keyed by
their ``"//"``-joined JAX paths, and a small manifest beside the npz
(``<out>.manifest.json``: file, sha256, size, array and parameter counts,
source checkpoint, the recipe to regenerate it, the decode's CER line and,
with ``--embed-model-cfg``, the run's model config). This is the anchor
recipe's stage-2 export; ``egs/synth_bench/trained/anchor_synth_f16.npz``
is in this format. A host tool: it reads and writes files only.

    python tools/torch_export_trained_synth.py EXP/model.average.from75to79 OUT.npz \\
        --result EXP/decode_test_bw5_pn0.6_ml32_avg75-79/RESULT --embed-model-cfg
"""

import argparse
import hashlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from opentransformer_tpu_torch.train.checkpoint import PARAMS, Checkpointer  # noqa: E402


def checkpoint_dir(path: str) -> str:
    """A checkpoint directory, or an expdir's newest ``model.epoch.N``."""
    path = path.rstrip("/")
    if os.path.exists(os.path.join(path, PARAMS)):
        return path
    ck = Checkpointer(path)
    epochs = ck.list_epochs()
    if not epochs:
        raise SystemExit(f"error: no {PARAMS} and no model.epoch.N under {path}")
    return ck.epoch_path(epochs[-1])


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export port params as the f16 npz + manifest")
    p.add_argument("checkpoint", help="checkpoint directory (model.average.*) or expdir")
    p.add_argument("out", help="output .npz path")
    p.add_argument("--result", default=None,
                   help="decode RESULT file whose CER line goes in the manifest")
    p.add_argument("--embed-model-cfg", action="store_true",
                   help="write the run's model config into the manifest")
    p.add_argument("--regenerate", default="python tools/torch_anchor_recipe.py",
                   help="recipe recorded in the manifest's regenerate field")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    src = checkpoint_dir(args.checkpoint)
    with np.load(os.path.join(src, PARAMS)) as z:
        flat = {k: z[k] for k in z.files}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **{k: v.astype(np.float16) for k, v in flat.items()})
    mb = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out}: {len(flat)} arrays, {mb:.1f} MB (f16)")
    with open(args.out, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    manifest = {"file": os.path.basename(args.out), "sha256": sha, "size_mb": round(mb, 1),
                "n_arrays": len(flat), "n_params": int(sum(v.size for v in flat.values())),
                "source_checkpoint": os.path.basename(src), "regenerate": args.regenerate}
    if args.result and os.path.exists(args.result):
        with open(args.result, encoding="utf-8") as f:
            for line in f:
                if line.startswith("CER"):
                    manifest["test_cer"] = line.strip()
                    break
    if args.embed_model_cfg:
        cfg = Checkpointer(os.path.dirname(os.path.abspath(src))).load_config()
        if not cfg or "model" not in cfg:
            raise SystemExit("--embed-model-cfg: no config.json with a model section beside "
                             f"{src}")
        manifest["model_cfg"] = dict(cfg["model"])
    man_path = os.path.splitext(args.out)[0] + ".manifest.json"
    with open(man_path, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2)
        f.write("\n")
    print(f"wrote {man_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
