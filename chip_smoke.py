#!/usr/bin/env python
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a build) and the repository
around it; it exits non-zero, printing no result, without either. Phases,
each of which raises on failure:

  0. build every kernel of the port from ``opentransformer_tpu_torch/csrc``
     with nvcc and print ptxas's register and shared-memory lines;
  1. hold the ``project_logp_topk`` kernel against its plain PyTorch
     version on the card at the decode shapes, including ties, and time the
     kernel, the plain version and the unfused three-call composition;
  2. decode the 500-utterance synthetic test split with the committed
     anchor weights through the eval CLI in float32 (fails above 0.75% CER;
     the JAX package scored 0.65%) and in bfloat16, showing the decode went
     through the kernel;
  3. drive the flagship geometry (d256, 12 encoder + 6 decoder blocks,
     V=4233) with seeded random weights: beam 5, bf16, 512 utterances x 500
     frames, 24 steps with EOS disabled, as bench.py's worst-case row.

The two lines before the last are the kernels' JSON record and the card's
name and power limit; the last line is the run's JSON status.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
ANCHOR = os.path.join(REPO, "egs", "synth_bench", "trained", "anchor_synth_f16")
ANCHOR_CER_LIMIT = 0.75
FLAGSHIP_CFG = {
    "type": "speech2text",
    "frontend": {"input_size": 40, "output_size": 256, "in_channel": 1, "mid_channel": 64,
                 "out_channel": 128, "kernel_size": [[3, 3], [3, 3]], "stride": [2, 2]},
    "encoder": {"d_model": 256, "n_heads": 4, "d_ff": 2048, "n_blocks": 12,
                "normalize_before": False, "activation": "glu"},
    "decoder": {"vocab_size": 4233, "d_model": 256, "n_heads": 4, "d_ff": 2048,
                "memory_dim": 256, "n_blocks": 6, "activation": "glu", "share_embedding": True},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def topk_bound_ms(n: int, d: int, v: int, k: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for one projection→log-softmax→top-k: the larger of its
    operations over the peak rate of ``dtype`` and its bytes (inputs read
    once, outputs written once) over the memory rate."""
    esize = torch.tensor([], dtype=dtype).element_size()
    flops = 2.0 * n * d * v
    nbytes = (n * d + v * d) * esize + v * 4 + n * k * 8 + n * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 0
def phase_build():
    from opentransformer_tpu_torch.ops import cuda_build

    sources = sorted(f[:-3] for f in os.listdir(cuda_build.CSRC_DIR) if f.endswith(".cu"))
    t0 = time.time()
    for name in sources:
        cuda_build.build(name)
    log(f"phase0 built {sources} in {time.time() - t0:.1f} s")
    for name in sources:
        for line in cuda_build.build_log(name).splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                log(f"phase0 {name}: {line.strip()}")


# ---------------------------------------------------------------- phase 1
def _inputs(n, d, v, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(n, d, generator=g)
    w = torch.randn(v, d, generator=g) * 0.3
    b = torch.randn(v, generator=g) * 0.1
    return h.cuda().to(dtype), w.cuda().to(dtype), b.cuda()


def check_topk(h, w, b, k, label):
    """Kernel vs plain on the same card tensors. Ids must agree wherever the
    plain values are not tied within ``tie``; values and lse within
    ``atol`` = 1e-4, for float32 and bf16 inputs alike: both paths see the
    same (possibly bf16) h and W, whose products are exact in float32, and
    accumulate in float32, so only the summation order differs.
    Every returned id must also carry its returned value in the full
    log-softmax. Returns the largest value error."""
    from opentransformer_tpu_torch.ops.project_topk import (
        project_logp_topk,
        project_logp_topk_plain,
    )

    vals, ids, lse = project_logp_topk(h, w, b, k, with_lse=True)
    torch.cuda.synchronize()
    logits = h.float() @ w.float().T + b.float()
    scale = logits.abs().max().item()
    atol = 1e-4
    tie = 1e-5 * max(scale, 1.0)
    ref_vals, ref_ids, ref_lse = project_logp_topk_plain(h, w, b, k, with_lse=True)
    k1 = min(k + 1, w.shape[0])
    wide, _ = project_logp_topk_plain(h, w, b, k1)
    gap = wide[:, :-1] - wide[:, 1:]
    sep = torch.ones_like(ref_vals, dtype=torch.bool)
    sep[:, 1:] &= gap[:, : k - 1] > tie
    if k1 > k:  # the k-th slot must also stand apart from the (k+1)-th value
        sep &= gap[:, :k] > tie
    bad_ids = int(((ids != ref_ids) & sep).sum())
    err = (vals - ref_vals).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    picked = torch.log_softmax(logits, -1).gather(1, ids.long())
    pick_err = (picked - vals).abs().max().item()
    ok = bad_ids == 0 and err <= atol and lse_err <= atol and pick_err <= atol
    log(f"phase1 {label}: max|dvals|={err:.3e} max|dlse|={lse_err:.3e} "
        f"max|dpicked|={pick_err:.3e} atol={atol:.1e} untied-id mismatches={bad_ids} "
        f"({int(sep.sum())} untied slots) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"project_logp_topk kernel disagrees with its plain version: {label}")
    return err


def phase_kernel():
    from opentransformer_tpu_torch.ops.project_topk import (
        project_logp_topk,
        project_logp_topk_plain,
    )

    cases = [
        ("flagship beam step N=2560 D=256 V=4233 k=5 bf16", 2560, 256, 4233, 5, torch.bfloat16),
        ("flagship beam step N=2560 D=256 V=4233 k=5 f32", 2560, 256, 4233, 5, torch.float32),
        ("anchor beam step N=500 D=128 V=4233 k=5 f32", 500, 128, 4233, 5, torch.float32),
        ("greedy k=1 N=512 D=256 V=4233 bf16", 512, 256, 4233, 1, torch.bfloat16),
        ("CTC sparse beam k=32+lse N=4096 D=256 V=4233 f32", 4096, 256, 4233, 32, torch.float32),
        ("ragged N=7 D=256 V=4233 k=5 bf16", 7, 256, 4233, 5, torch.bfloat16),
        ("widest k=128 N=33 D=40 V=131 f32", 33, 40, 131, 128, torch.float32),
    ]
    max_err = 0.0
    for i, (label, n, d, v, k, dtype) in enumerate(cases):
        max_err = max(max_err, check_topk(*_inputs(n, d, v, dtype, seed=i), k, label))
    # hand-made ties: identical rows; every logit value appears 40 times
    g = torch.Generator().manual_seed(3)
    h = torch.linspace(-1.0, 1.0, 16).repeat(4, 1).cuda()
    w = torch.randn(7, 16, generator=g).repeat(40, 1).cuda()
    b = torch.zeros(280, device="cuda")
    vals, ids = project_logp_topk(h, w, b, 6)
    ref_vals, ref_ids = project_logp_topk_plain(h, w, b, 6)
    if not torch.equal(ids, ref_ids):
        raise AssertionError(f"tie rule broken: kernel {ids.tolist()} plain {ref_ids.tolist()}")
    log(f"phase1 ties: ids identical to the plain version {ids[0].tolist()} ok")

    card = card_line()
    timings = {}
    for label, n, d, k, dtype in (("flagship bf16", 2560, 256, 5, torch.bfloat16),
                                  ("flagship f32", 2560, 256, 5, torch.float32),
                                  ("anchor f32", 500, 128, 5, torch.float32)):
        h, w, b = _inputs(n, d, 4233, dtype, seed=99)
        kern = cuda_ms(lambda: project_logp_topk(h, w, b, k))
        plain = cuda_ms(lambda: project_logp_topk_plain(h, w, b, k))
        unfused = cuda_ms(lambda: torch.topk(torch.log_softmax(
            (h @ w.T).float() + b, dim=-1), k))
        bound, bound_by = topk_bound_ms(n, d, 4233, k, dtype)
        timings[label] = (kern, plain, bound, bound_by)
        log(f"phase1 time {label} N={n} D={d} V=4233 k={k}: kernel {kern:.4f} ms, "
            f"plain version {plain:.4f} ms, unfused matmul+log_softmax+topk "
            f"(a composition of three calls, not a library call) {unfused:.4f} ms, "
            f"bound {bound:.4f} ms ({bound_by}) [{card}]")
    return max_err, timings


# ---------------------------------------------------------------- phase 2
def phase_anchor(workdir: str):
    from opentransformer_tpu_torch.cli import eval as eval_cli
    from opentransformer_tpu_torch.data import synth
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk

    data = os.path.join(workdir, "synth")
    t0 = time.time()
    synth.write_corpus(data, splits=("test",))
    log(f"phase2 wrote the synthetic test split (500 utts) in {time.time() - t0:.1f} s")
    cers = {}
    for dtype in ("float32", "bfloat16"):
        out = os.path.join(workdir, f"decode_{dtype}")
        project_logp_topk.launches = 0
        t0 = time.time()
        rc = eval_cli.main([
            "--npz", ANCHOR + ".npz", "--model_cfg", ANCHOR + ".manifest.json",
            "--feats", os.path.join(data, "test", "feats.scp"),
            "--text", os.path.join(data, "test", "text"),
            "--vocab", os.path.join(data, "vocab"),
            "-b", "100", "-bw", "5", "-pn", "0.6", "-ml", "32",
            "--dtype", dtype, "--decode_dir", out])
        launches = project_logp_topk.launches
        with open(os.path.join(out, "RESULT")) as f:
            result = f.read().splitlines()
        cer = float(result[0].split()[1].rstrip("%"))
        cers[dtype] = cer
        log(f"phase2 anchor {dtype}: {result[0]} | {result[1]} | {result[2]} | {result[3]} | "
            f"kernel launches {launches} | wall {time.time() - t0:.1f} s [{card_line()}]")
        if rc != 0 or launches == 0:
            raise AssertionError(f"anchor {dtype} decode did not run through the kernel")
    if cers["float32"] > ANCHOR_CER_LIMIT:
        raise AssertionError(f"anchor f32 CER {cers['float32']}% above {ANCHOR_CER_LIMIT}% "
                             "(JAX package: 0.65%, 58/8958)")
    log(f"phase2 anchor f32 CER {cers['float32']}% <= {ANCHOR_CER_LIMIT}% ok "
        f"(JAX package 0.65%); bf16 CER {cers['bfloat16']}%")


# ---------------------------------------------------------------- phase 3
def flagship_model(dtype, seed: int = 0, device=None):
    """The flagship geometry with seeded random weights, made in the JAX
    package's layout and carried over by ``compat.params_from_jax``."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.models.registry import build_model

    model = build_model(FLAGSHIP_CFG, dtype=dtype, device=device)
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = fill(val)
            elif key == "scale":
                out[key] = np.ones_like(val)
            elif key == "embedding":
                out[key] = rng.normal(size=val.shape).astype(np.float32)
            else:  # kernels U(±1/sqrt(fan_in)), biases U(±1/sqrt(width))
                fan_in = int(np.prod(val.shape[:-1])) if key == "kernel" else val.shape[0]
                bound = 1.0 / np.sqrt(fan_in)
                out[key] = rng.uniform(-bound, bound, size=val.shape).astype(np.float32)
        return out

    return compat.load_into(model, fill(compat.params_to_jax(model)))


def phase_flagship():
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk
    from opentransformer_tpu_torch.recognize.base import make_memory_search

    batch, frames, max_len, beam = 512, 500, 24, 5
    # small-input check first: fused and unfused decode give the same ids
    model32 = flagship_model(torch.float32)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 200, 40, generator=g).cuda()
    m = torch.ones(2, 200, dtype=torch.bool, device="cuda")
    with torch.inference_mode():
        mem, mm = model32.encode(x, m)
    fused = make_memory_search(model32, beam, 8, eos_id=-1)(mem, mm)
    plain = make_memory_search(model32, beam, 8, eos_id=-1, fused_topk=False)(mem, mm)
    if not torch.equal(fused.tokens, plain.tokens):
        raise AssertionError("flagship f32: fused and unfused decodes disagree")
    log("phase3 flagship f32 small input: fused-kernel decode == unfused decode ok")
    del model32

    model = flagship_model(torch.bfloat16)
    search = make_memory_search(model, beam, max_len, eos_id=-1)
    g = torch.Generator().manual_seed(2)
    feats = torch.randn(batch, frames, 40, generator=g).cuda()
    mask = torch.ones(batch, frames, dtype=torch.bool, device="cuda")

    def run():
        with torch.inference_mode():
            memory, memory_mask = model.encode(feats, mask)
            return search(memory, memory_mask)

    run()  # warm-up: cuBLAS/cuDNN plans, kernel library load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    project_logp_topk.launches = 0
    hyp = run()
    torch.cuda.synchronize()
    launches = project_logp_topk.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    shape_ok = tuple(hyp.tokens.shape) == (batch, beam, max_len + 1)
    finite = bool(torch.isfinite(hyp.scores).all())
    full = bool((hyp.lengths == max_len + 1).all())
    # the host clock varies from run to run: time three more and take the median
    times = []
    for _ in range(3):
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    secs = sorted(times)[1]
    log(f"phase3 flagship bf16 beam {beam} B={batch} x {frames} frames, {max_len} steps: "
        f"median {secs:.3f} s of {[round(t, 3) for t in times]}, {batch / secs:.2f} utts/s, "
        f"RTFx {batch * frames * 0.01 / secs:.2f}, peak memory {peak:.2f} GiB, "
        f"kernel launches {launches} [{card_line()}]")
    if not (shape_ok and finite and full):
        raise AssertionError(f"flagship decode output wrong: shape {tuple(hyp.tokens.shape)}, "
                             f"finite {finite}, all full-length {full}")
    if launches != max_len:
        raise AssertionError(f"expected one kernel launch per decode step ({max_len}), "
                             f"counted {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import opentransformer_tpu_torch  # noqa: F401  (fails outside the repository)

    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    phase_build()
    max_err, timings = phase_kernel()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        phase_anchor(workdir)
    launches = phase_flagship()

    kern, plain, bound, bound_by = timings["flagship bf16"]
    record = {"kernels": [{
        "name": "project_logp_topk", "route": "cuda",
        "source": "opentransformer_tpu_torch/csrc/project_topk.cu",
        "replaces": "opentransformer_tpu/ops/project_topk.py:96",
        "launches": launches, "max_abs_err": max_err, "ms": kern, "plain_ms": plain,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
    }]}
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
