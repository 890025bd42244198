#!/usr/bin/env python
"""Device time of the port's top-k kernels, split by CUDA kernel.

    python3 tools/torch_topk_profile.py [--iters 20]

Runs ``project_logp_topk`` and ``project2_logp_topk`` at the flagship beam
step (N=2560, D=256, V=4233, k=5, bf16 and float32) and the anchor shape
under ``torch.profiler`` and prints, for each, the device time per launch of
every kernel it ran: pass 1 (``partial_topk*``) and the merge pass
(``merge_topk*``). Needs a CUDA card; the kernels are built at first use.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def inputs(n, d, v, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(n, d, generator=g)
    w = torch.randn(v, d, generator=g) * 0.3
    b = torch.randn(v, generator=g) * 0.1
    return h.cuda().to(dtype), w.cuda().to(dtype), b.cuda()


def profile(label, fn, iters):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    parts = []
    for e in p.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = e.cuda_time_total
        name = re.search(r"(partial|merge)_topk2?_kernel", e.key)
        if dev_us > 0 and name:
            parts.append((name.group(0), dev_us / 1e3 / iters))
    total = sum(ms for _, ms in parts)
    detail = ", ".join(f"{name} {ms:.4f} ms" for name, ms in sorted(parts, key=lambda x: -x[1]))
    print(f"{label}: {total:.4f} ms of device time per call ({detail})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_topk_profile: no CUDA device available", file=sys.stderr)
        return 1
    from opentransformer_tpu_torch.ops.project_topk import project2_logp_topk, project_logp_topk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    for label, n, d, k, dtype in (("one-head flagship bf16", 2560, 256, 5, torch.bfloat16),
                                  ("one-head flagship f32", 2560, 256, 5, torch.float32),
                                  ("one-head anchor f32", 500, 128, 5, torch.float32),
                                  ("one-head CTC k=32 f32", 4096, 256, 32, torch.float32)):
        h, w, b = inputs(n, d, 4233, dtype, seed=99)
        profile(f"{label} N={n} D={d} k={k}", lambda: project_logp_topk(h, w, b, k), args.iters)
    for label, n, d1, d2, dtype in (("two-head flagship bf16", 2560, 256, 256, torch.bfloat16),
                                    ("two-head flagship f32", 2560, 256, 256, torch.float32),
                                    ("two-head LSTM-LM widths bf16", 2560, 256, 1024,
                                     torch.bfloat16)):
        a = inputs(n, d1, 4233, dtype, seed=199) + inputs(n, d2, 4233, dtype, seed=1199)
        profile(f"{label} N={n} D1={d1} D2={d2} k=5", lambda: project2_logp_topk(*a, 0.1, 5),
                args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
