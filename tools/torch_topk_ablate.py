#!/usr/bin/env python
"""Where the top-k kernels' time goes: each stage taken out in turn.

    python3 tools/torch_topk_ablate.py

Builds variants of ``csrc/project_topk.cu`` and ``csrc/project2_topk.cu``
from patched copies of ``csrc`` (under the gitignored ``_build/ablate``),
each with one stage of pass 1 replaced by a trivial stand-in, and times
every variant at the flagship beam step (N=2560, D=256, V=4233, k=5; bf16
and float32) and the anchor shape with CUDA events. The variants compute
wrong results: their times say only what each stage costs. Needs a CUDA
card.

  base         the kernels as committed
  no_offer     the lane lists take no value (k <= 8; the merge still runs)
  no_exp       the online logsumexp sums the logits instead of their exps
  no_mma       the tensor-core instructions are replaced by one add
  no_copy      the ring slots are never filled (no cp.async)
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LSE = "      se += expf(x[j][2 * r] - m_new) + expf(x[j][2 * r + 1] - m_new);"
TF32_MMA = ("      mma_tf32(acc[j], a_lo, b0_hi, b1_hi);\n"
            "      mma_tf32(acc[j], a_hi, b0_lo, b1_lo);\n"
            "      mma_tf32(acc[j], a_hi, b0_hi, b1_hi);")
COPY = ("      cp_async16(slot + r * kRowBytes + q * 16, ok ? base + (size_t)gr * d + gc : base,\n"
        "                 ok ? 16 : 0);")
VARIANTS = {
    "base": [],
    "no_offer": [("  if (hits == 0) return;", "  return;")],
    "no_exp": [(LSE, "      se += x[j][2 * r] + x[j][2 * r + 1];")],
    "no_mma": [("mma_bf16(acc[j], a, lds32(bj), lds32(bj + 16));",
                "acc[j][0] += __uint_as_float(lds32(bj) ^ lds32(bj + 16) ^ a[0] ^ a[3]);"),
               (TF32_MMA, "      acc[j][0] += __uint_as_float(b0_hi ^ b0_lo ^ b1_hi ^ b1_lo ^ "
                          "a_lo[0] ^ a_hi[3]);")],
    "no_copy": [(COPY, "      (void)ok;")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_topk_ablate: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from opentransformer_tpu_torch.ops import cuda_build
    from opentransformer_tpu_torch.ops import project_topk as pt

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    shapes = [("one-head flagship bf16", 1, 2560, 256, torch.bfloat16),
              ("one-head flagship f32", 1, 2560, 256, torch.float32),
              ("one-head anchor f32", 1, 500, 128, torch.float32),
              ("two-head flagship bf16", 2, 2560, 256, torch.bfloat16)]
    data = {label: (cs._inputs(n, d, 4233, dt, 99) if kind == 1
                    else cs._inputs2(n, d, d, 4233, dt, 199))
            for label, kind, n, d, dt in shapes}
    source = cuda_build.CSRC_DIR
    for name, patches in VARIANTS.items():
        dst = os.path.join(cuda_build.BUILD_DIR, "ablate", name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(source, dst)
        path = os.path.join(dst, "topk_common.cuh")
        with open(path) as f:
            text = f.read()
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the patched line is no longer in topk_common.cuh: "
                                   f"{old.strip()[:60]}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        cuda_build.CSRC_DIR = dst
        cuda_build._loaded.clear()
        cuda_build.build_all(["project_topk", "project2_topk"])
        times = []
        for label, kind, *_ in shapes:
            a = data[label]
            if kind == 1:
                ms = cs.cuda_ms(lambda: pt.project_logp_topk(*a, 5))
            else:
                ms = cs.cuda_ms(lambda: pt.project2_logp_topk(*a, 0.1, 5))
            times.append(f"{label} {ms:.4f} ms")
        print(f"ablation {name}: {', '.join(times)} [{card}]", flush=True)
    cuda_build.CSRC_DIR = source
    cuda_build._loaded.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
