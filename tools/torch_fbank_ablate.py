#!/usr/bin/env python
"""Where the fbank kernel's time goes: stages taken out, and variants.

    python3 tools/torch_fbank_ablate.py

Builds variants of ``csrc/fbank_spec_mel.cu`` from patched copies of
``csrc`` (under the gitignored ``_build/ablate``) and times each on
``chip_smoke.py`` phase 6's timed batch (16 utterances of 10 s, 15,968
frames, M = 40), cold as phase 6 times it (four frame buffers in turn),
in three rounds: device time per call from ``torch.profiler``. Each
variant's largest |Δ log-mel| against the plain version is printed beside
it: the ablations compute wrong results, and their times say only what the
stage costs. Needs a CUDA card.

  base          the kernel as committed
  no_mel        the mel loop reads one power value a bin (FFT, power, I/O)
  no_fft        the three FFT passes and the post-step are skipped: the
                loaded samples go straight to the power row (I/O, mel)
  mel_rolled    the mel loop not unrolled (the same sums)
  warps4        4 warps a block, 4 blocks an SM (the same 16 warps an SM)
  blocks3       launch bounds of 3 blocks an SM: 24 warps, at most 85 registers
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MEL_LOOP = ("#pragma unroll 4\n"
            "      for (int q = lo; q < hi; ++q) acc = fmaf(power[q], wt[q], acc);")
FFT_START = "    // pass A, then slab[k1][a]"
FFT_END = "    // mel bins lane + 32 j over their own ranges, then the log"
VARIANTS = {
    "base": [],
    "no_mel": [(MEL_LOOP, "      acc = power[lo] * wt[lo];")],
    "no_fft": [(FFT_START, "#if 0\n" + FFT_START),
               (FFT_END, "#endif\n"
                "#pragma unroll\n"
                "    for (int v = 0; v < 8; ++v) power[lane + 32 * v] = z[v & 1][v >> 1].x;\n"
                "    if (lane == 0) power[kFreq - 1] = z[0][0].y;\n"
                "    __syncwarp();\n" + FFT_END)],
    "mel_rolled": [(MEL_LOOP, MEL_LOOP.replace("#pragma unroll 4", "#pragma unroll 1"))],
    "warps4": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;"),
               ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 4)")],
    "blocks3": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fbank_ablate: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from opentransformer_tpu_torch.ops import cuda_build
    from opentransformer_tpu_torch.ops import fbank_kernel as fk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    b, n, bins = cs.FBANK_TIMED
    w, _ = cs.fbank_waves(b, n, seed=99)
    flats = [fk.extract_frames(w.clone()).reshape(-1, 400) for _ in range(4)]
    tab = fk.device_bases(bins, 16000.0, flats[0].device)
    args = (tab.mel_t, tab.twiddles, tab.mel_ranges)
    plain = fk.spec_mel_plain(flats[0], tab.cos, tab.sin, tab.mel_t)
    source = cuda_build.CSRC_DIR
    libs = {}
    for name, patches in VARIANTS.items():
        dst = os.path.join(cuda_build.BUILD_DIR, "ablate", name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(source, dst)
        path = os.path.join(dst, "fbank_spec_mel.cu")
        with open(path) as f:
            text = f.read()
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the patched line is no longer in fbank_spec_mel.cu: "
                                   f"{old.strip()[:60]}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        cuda_build.CSRC_DIR = dst
        cuda_build.build("fbank_spec_mel")
        regs = [line.strip() for line in cuda_build.build_log("fbank_spec_mel").splitlines()
                if "Used" in line or "spill" in line]
        print(f"ablation {name} build: {' | '.join(regs)}", flush=True)
        libs[name] = dst
    times = {name: [] for name in VARIANTS}
    errs = {}
    for _ in range(3):  # three rounds, the variants in turn within each
        for name, dst in libs.items():
            cuda_build.CSRC_DIR = dst
            cuda_build._loaded.clear()
            errs[name] = (fk.spec_mel(flats[0], *args) - plain).abs().max().item()
            times[name].append(cs.device_ms_cold(lambda x: fk.spec_mel(x, *args), flats))
    for name in VARIANTS:
        print(f"ablation {name}: {min(times[name]):.4f} ms (rounds "
              f"{[round(t, 4) for t in times[name]]}), max|d| vs plain {errs[name]:.2e} [{card}]",
              flush=True)
    cuda_build.CSRC_DIR = source
    cuda_build._loaded.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
