#!/usr/bin/env python
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a build) and the repository
around it; it exits non-zero, printing no result, without either. Phases,
each of which raises on failure:

  0. build every kernel of the port from ``opentransformer_tpu_torch/csrc``
     with nvcc (one process per source, all at once) and print ptxas's
     register and shared-memory lines;
  1. hold the ``project_logp_topk`` kernel against its plain PyTorch
     version on the card at the decode shapes, including ties, and time the
     kernel, the plain version and the unfused three-call composition;
  1b. the same for the two-head ``project2_logp_topk`` kernel of LM shallow
     fusion: flagship, LSTM-LM and anchor widths, lm weights 0.1, 0 and
     -0.3, ties;
  2. decode the 500-utterance synthetic test split with the committed
     anchor weights through the eval CLI in float32 (fails above 0.75% CER;
     the JAX package scored 0.65%) and in bfloat16, showing the decode went
     through the kernel;
  3. drive the flagship geometry (d256, 12 encoder + 6 decoder blocks,
     V=4233) with seeded random weights: beam 5, bf16, 512 utterances x 500
     frames, 24 steps with EOS disabled, as bench.py's worst-case row;
  4. decode the anchor split through the eval CLI with a seeded random
     transformer LM handed over as an npz: at ``-lmw 0.0`` the fused score
     is the model's own, so the CER limit of phase 2 holds and every step
     must have gone through the two-head kernel; ``-lmw 0.1`` and
     ``-lm_resc 0.1`` are run and reported (the LM is untrained);
  5. the flagship geometry with LM shallow fusion: fused and unfused
     decodes agree on a small input for a transformer LM (ancestry-map
     caches) and an LSTM LM (gathered state), then the worst case of phase 3
     with bench.py's ``lm_fusion`` LM, one two-head launch per step, and
     what fusion costs: decodes without and with the LM timed in turns.

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
# the LM of bench.py's lm_fusion row, and the LSTM LM of egs/aishell/conf/rnnlm.yaml
FLAGSHIP_LM_CFG = {"type": "transformer_lm", "vocab_size": 4233, "d_model": 256, "n_heads": 4,
                   "d_ff": 2048, "num_blocks": 6, "activation": "glu", "share_embedding": True}
LSTM_LM_CFG = {"type": "rnn_lm", "vocab_size": 4233, "num_layers": 2, "hidden_size": 1024,
               "share_embedding": True}
# anchor-sized LM for the CLI phase: the flagship LM's widths, depth cut to 2
ANCHOR_LM_CFG = dict(FLAGSHIP_LM_CFG, num_blocks=2)
WORST_CASE = dict(batch=512, frames=500, max_len=24, beam=5)


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


def topk2_bound_ms(n: int, d1: int, d2: int, v: int, k: int,
                   dtype: torch.dtype) -> tuple[float, str]:
    """The same for the two-head form: two projections, two biases, one
    list of k values and ids per row."""
    esize = torch.tensor([], dtype=dtype).element_size()
    flops = 2.0 * n * v * (d1 + d2)
    nbytes = (n + v) * (d1 + d2) * esize + 8 * v + 8 * n * k
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
    cuda_build.build_all(sources)
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


def untied_slots(wide: torch.Tensor, k: int, tie: float) -> torch.Tensor:
    """bool[N, k]: the slots of a plain top-k whose ids a kernel must
    reproduce, given the plain top-(k+1) values ``wide`` (top-k when k = V):
    those whose value stands more than ``tie`` apart from both neighbours."""
    gap = wide[:, :-1] - wide[:, 1:]
    sep = torch.ones((wide.shape[0], k), dtype=torch.bool, device=wide.device)
    sep[:, 1:] &= gap[:, : k - 1] > tie
    if wide.shape[1] > k:  # the k-th slot must also stand apart from the (k+1)-th value
        sep &= gap[:, :k] > tie
    return sep


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
    wide, _ = project_logp_topk_plain(h, w, b, min(k + 1, w.shape[0]))
    sep = untied_slots(wide, k, tie)
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


# ---------------------------------------------------------------- phase 1b
def _inputs2(n, d1, d2, v, dtype, seed):
    return _inputs(n, d1, v, dtype, seed) + _inputs(n, d2, v, dtype, seed + 1000)


def check_topk2(args, lam, k, label):
    """Two-head kernel vs plain on the same card tensors, as ``check_topk``:
    ids agree wherever the plain values are not tied within ``tie``, values
    within ``atol`` = 1e-4 (both paths accumulate the same inputs in
    float32; they differ in summation order and in where the two
    normalisers are subtracted), and every returned id carries its returned
    value in the materialised ``lp1 + lam * lp2``. Returns the largest
    value error."""
    from opentransformer_tpu_torch.ops.project_topk import (
        project2_logp_topk,
        project2_logp_topk_plain,
    )

    h1, w1, b1, h2, w2, b2 = args
    vals, ids = project2_logp_topk(*args, lam, k)
    torch.cuda.synchronize()
    l1 = h1.float() @ w1.float().T + b1.float()
    l2 = h2.float() @ w2.float().T + b2.float()
    atol = 1e-4
    tie = 1e-5 * max(l1.abs().max().item(), abs(lam) * l2.abs().max().item(), 1.0)
    ref_vals, ref_ids = project2_logp_topk_plain(*args, lam, k)
    wide, _ = project2_logp_topk_plain(*args, lam, min(k + 1, w1.shape[0]))
    sep = untied_slots(wide, k, tie)
    bad_ids = int(((ids != ref_ids) & sep).sum())
    err = (vals - ref_vals).abs().max().item()
    combined = torch.log_softmax(l1, -1) + lam * torch.log_softmax(l2, -1)
    pick_err = (combined.gather(1, ids.long()) - vals).abs().max().item()
    ok = bad_ids == 0 and err <= atol and pick_err <= atol
    log(f"phase1b {label} lam={lam}: max|dvals|={err:.3e} max|dpicked|={pick_err:.3e} "
        f"atol={atol:.1e} untied-id mismatches={bad_ids} ({int(sep.sum())} untied slots) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"project2_logp_topk kernel disagrees with its plain version: {label}")
    return err


def phase_kernel2():
    from opentransformer_tpu_torch.ops.project_topk import (
        project2_logp_topk,
        project2_logp_topk_plain,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("flagship beam step N=2560 D1=D2=256 V=4233 k=5 bf16", 2560, 256, 256, 4233, 5, bf16, 0.1),
        ("flagship beam step N=2560 D1=D2=256 V=4233 k=5 f32", 2560, 256, 256, 4233, 5, f32, 0.1),
        ("flagship beam step f32", 2560, 256, 256, 4233, 5, f32, 0.0),
        ("flagship beam step f32", 2560, 256, 256, 4233, 5, f32, -0.3),
        ("LSTM-LM widths N=2560 D1=256 D2=1024 V=4233 k=5 bf16", 2560, 256, 1024, 4233, 5, bf16, 0.1),
        ("anchor beam step N=500 D1=128 D2=256 V=4233 k=5 f32", 500, 128, 256, 4233, 5, f32, 0.1),
        ("anchor beam step f32", 500, 128, 256, 4233, 5, f32, 0.0),
        ("ragged N=7 D1=D2=256 V=4233 k=5 bf16", 7, 256, 256, 4233, 5, bf16, -0.3),
        ("widest k=128 N=33 D1=40 D2=56 V=131 f32", 33, 40, 56, 131, 128, f32, 0.1),
    ]
    max_err = 0.0
    for i, (label, n, d1, d2, v, k, dtype, lam) in enumerate(cases):
        args = _inputs2(n, d1, d2, v, dtype, seed=100 + i)
        max_err = max(max_err, check_topk2(args, lam, k, label))
    # hand-made ties: identical rows; every combined value appears 40 times
    g = torch.Generator().manual_seed(3)
    h1 = torch.linspace(-1.0, 1.0, 16).repeat(4, 1).cuda()
    h2 = torch.linspace(1.0, -0.5, 24).repeat(4, 1).cuda()
    w1 = torch.randn(7, 16, generator=g).repeat(40, 1).cuda()
    w2 = torch.randn(7, 24, generator=g).repeat(40, 1).cuda()
    b = torch.zeros(280, device="cuda")
    for lam in (0.1, 0.0, -0.3):
        vals, ids = project2_logp_topk(h1, w1, b, h2, w2, b, lam, 6)
        ref_vals, ref_ids = project2_logp_topk_plain(h1, w1, b, h2, w2, b, lam, 6)
        if not torch.equal(ids, ref_ids):
            raise AssertionError(f"tie rule broken at lam={lam}: kernel {ids.tolist()} "
                                 f"plain {ref_ids.tolist()}")
        log(f"phase1b ties lam={lam}: ids identical to the plain version {ids[0].tolist()} ok")

    card = card_line()
    timings = {}
    for label, n, d1, d2, k, dtype in (("flagship bf16", 2560, 256, 256, 5, bf16),
                                       ("flagship f32", 2560, 256, 256, 5, f32),
                                       ("anchor f32", 500, 128, 256, 5, f32),
                                       ("LSTM-LM widths bf16", 2560, 256, 1024, 5, bf16)):
        h1, w1, b1, h2, w2, b2 = args = _inputs2(n, d1, d2, 4233, dtype, seed=199)
        kern = cuda_ms(lambda: project2_logp_topk(*args, 0.1, k))
        plain = cuda_ms(lambda: project2_logp_topk_plain(*args, 0.1, k))
        unfused = cuda_ms(lambda: torch.topk(
            torch.log_softmax((h1 @ w1.T).float() + b1, dim=-1)
            + 0.1 * torch.log_softmax((h2 @ w2.T).float() + b2, dim=-1), k))
        bound, bound_by = topk2_bound_ms(n, d1, d2, 4233, k, dtype)
        timings[label] = (kern, plain, bound, bound_by)
        log(f"phase1b time {label} N={n} D1={d1} D2={d2} V=4233 k={k}: kernel {kern:.4f} ms, "
            f"plain version {plain:.4f} ms, unfused 2 matmuls + 2 log_softmax + add + topk "
            f"(a composition of calls, not a library call) {unfused:.4f} ms, "
            f"bound {bound:.4f} ms ({bound_by}) [{card}]")
    return max_err, timings


# ---------------------------------------------------------------- phase 2
def anchor_decode(tag: str, data: str, out: str, dtype: str, extra=()):
    """The 500-utterance split through the eval CLI → (CER %, one-head
    launches, two-head launches); logs the RESULT lines."""
    from opentransformer_tpu_torch.cli import eval as eval_cli
    from opentransformer_tpu_torch.ops.project_topk import project2_logp_topk, project_logp_topk

    project_logp_topk.launches = project2_logp_topk.launches = 0
    t0 = time.time()
    rc = eval_cli.main([
        "--npz", ANCHOR + ".npz", "--model_cfg", ANCHOR + ".manifest.json",
        "--feats", os.path.join(data, "test", "feats.scp"),
        "--text", os.path.join(data, "test", "text"),
        "--vocab", os.path.join(data, "vocab"),
        "-b", "100", "-bw", "5", "-pn", "0.6", "-ml", "32",
        "--dtype", dtype, "--decode_dir", out, *extra])
    one, two = project_logp_topk.launches, project2_logp_topk.launches
    with open(os.path.join(out, "RESULT")) as f:
        result = f.read().splitlines()
    log(f"{tag}: {result[0]} | {result[1]} | {result[2]} | {result[3]} | "
        f"kernel launches one-head {one} two-head {two} | wall {time.time() - t0:.1f} s "
        f"[{card_line()}]")
    if rc != 0:
        raise AssertionError(f"{tag}: the eval CLI returned {rc}")
    return float(result[0].split()[1].rstrip("%")), one, two


def phase_anchor(workdir: str):
    from opentransformer_tpu_torch.data import synth

    data = os.path.join(workdir, "synth")
    t0 = time.time()
    synth.write_corpus(data, splits=("test",))
    log(f"phase2 wrote the synthetic test split (500 utts) in {time.time() - t0:.1f} s")
    cers = {}
    for dtype in ("float32", "bfloat16"):
        cers[dtype], launches, _ = anchor_decode(
            f"phase2 anchor {dtype}", data, os.path.join(workdir, f"decode_{dtype}"), dtype)
        if launches == 0:
            raise AssertionError(f"anchor {dtype} decode did not run through the kernel")
    if cers["float32"] > ANCHOR_CER_LIMIT:
        raise AssertionError(f"anchor f32 CER {cers['float32']}% above {ANCHOR_CER_LIMIT}% "
                             "(JAX package: 0.65%, 58/8958)")
    log(f"phase2 anchor f32 CER {cers['float32']}% <= {ANCHOR_CER_LIMIT}% ok "
        f"(JAX package 0.65%); bf16 CER {cers['bfloat16']}%")
    return data


# ---------------------------------------------------------------- phase 3
def seeded_params(model, seed: int, embedding_std: float = 1.0) -> dict:
    """Seeded random weights for ``model`` in the JAX package's layout
    (numpy generator; shapes taken from the model's own parameters)."""
    from opentransformer_tpu_torch import compat

    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = fill(val)
            elif key == "scale":
                out[key] = np.ones_like(val)
            elif key == "embedding":
                out[key] = (embedding_std * rng.normal(size=val.shape)).astype(np.float32)
            else:  # kernels U(±1/sqrt(fan_in)), biases U(±1/sqrt(width))
                fan_in = int(np.prod(val.shape[:-1])) if key == "kernel" else val.shape[0]
                bound = 1.0 / np.sqrt(fan_in)
                out[key] = rng.uniform(-bound, bound, size=val.shape).astype(np.float32)
        return out

    return fill(compat.params_to_jax(model))


def seeded_model(cfg: dict, dtype, seed: int):
    """``cfg`` built on the card with seeded random weights, made in the
    JAX package's layout and carried over by ``compat.params_from_jax``."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.models.registry import build_model

    model = build_model(cfg, dtype=dtype)
    return compat.load_into(model, seeded_params(model, seed))


def small_input_check(tag: str, model32, lm=None):
    """Fused and unfused decodes of a small float32 input give the same ids."""
    from opentransformer_tpu_torch.recognize.base import make_memory_search

    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 200, 40, generator=g).cuda()
    m = torch.ones(2, 200, dtype=torch.bool, device="cuda")
    with torch.inference_mode():
        mem, mm = model32.encode(x, m)
    beam = WORST_CASE["beam"]
    fused = make_memory_search(model32, beam, 8, lm=lm, eos_id=-1)(mem, mm)
    plain = make_memory_search(model32, beam, 8, lm=lm, eos_id=-1, fused_topk=False)(mem, mm)
    if not torch.equal(fused.tokens, plain.tokens):
        raise AssertionError(f"{tag}: fused and unfused decodes disagree")
    log(f"{tag} small input: fused-kernel decode == unfused decode ok")


def worst_case_run(model, lm=None):
    """The flagship worst case as a closure: encode + beam search, bf16
    model, beam 5, B=512 x 500 seeded random frames, 24 forced steps."""
    from opentransformer_tpu_torch.recognize.base import make_memory_search

    batch, frames, max_len, beam = (WORST_CASE[k] for k in ("batch", "frames", "max_len", "beam"))
    search = make_memory_search(model, beam, max_len, lm=lm, eos_id=-1)
    g = torch.Generator().manual_seed(2)
    feats = torch.randn(batch, frames, 40, generator=g).cuda()
    mask = torch.ones(batch, frames, dtype=torch.bool, device="cuda")

    def run():
        with torch.inference_mode():
            memory, memory_mask = model.encode(feats, mask)
            return search(memory, memory_mask)

    return run


def host_seconds(run) -> float:
    """Host-clock time of one ``run()`` ending in a device synchronise."""
    t0 = time.time()
    run()
    torch.cuda.synchronize()
    return time.time() - t0


def worst_case_decode(tag: str, model, lm=None):
    """One warm-up of the flagship worst case, one counted run (launch
    counts, peak memory, output checks), then the median of three timed
    runs. Returns (one-head launches, two-head launches)."""
    from opentransformer_tpu_torch.ops.project_topk import project2_logp_topk, project_logp_topk

    batch, frames, max_len, beam = (WORST_CASE[k] for k in ("batch", "frames", "max_len", "beam"))
    run = worst_case_run(model, lm)
    run()  # warm-up: cuBLAS/cuDNN plans, kernel library load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    project_logp_topk.launches = project2_logp_topk.launches = 0
    hyp = run()
    torch.cuda.synchronize()
    one, two = project_logp_topk.launches, project2_logp_topk.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    shape_ok = tuple(hyp.tokens.shape) == (batch, beam, max_len + 1)
    finite = bool(torch.isfinite(hyp.scores).all())
    full = bool((hyp.lengths == max_len + 1).all())
    # the host clock varies from run to run: time three more and take the median
    times = [host_seconds(run) for _ in range(3)]
    secs = sorted(times)[1]
    log(f"{tag} bf16 beam {beam} B={batch} x {frames} frames, {max_len} steps: "
        f"median {secs:.3f} s of {[round(t, 3) for t in times]}, {batch / secs:.2f} utts/s, "
        f"RTFx {batch * frames * 0.01 / secs:.2f}, peak memory {peak:.2f} GiB, "
        f"kernel launches one-head {one} two-head {two} [{card_line()}]")
    if not (shape_ok and finite and full):
        raise AssertionError(f"{tag}: decode output wrong: shape {tuple(hyp.tokens.shape)}, "
                             f"finite {finite}, all full-length {full}")
    return one, two


def phase_flagship():
    small_input_check("phase3 flagship f32", seeded_model(FLAGSHIP_CFG, torch.float32, seed=0))
    one, two = worst_case_decode("phase3 flagship",
                                 seeded_model(FLAGSHIP_CFG, torch.bfloat16, seed=0))
    max_len = WORST_CASE["max_len"]
    if one != max_len or two != 0:
        raise AssertionError(f"expected one one-head kernel launch per decode step ({max_len}) "
                             f"and no two-head launch, counted {one} and {two}")
    return one


# ---------------------------------------------------------------- phase 4
def nbest_scores_sorted(decode_dir: str) -> int:
    """Number of utterances in ``predict.log``; raises unless each one's
    n-best scores are in descending order."""
    nbest: dict[str, list[float]] = {}
    with open(os.path.join(decode_dir, "predict.log")) as f:
        for line in f:
            utt, _, score = line.split()[:3]
            nbest.setdefault(utt, []).append(float(score.split("=")[1]))
    for utt, scores in nbest.items():
        if scores != sorted(scores, reverse=True):
            raise AssertionError(f"n-best scores of {utt} are not sorted: {scores}")
    return len(nbest)


def phase_anchor_lm(workdir: str, data: str):
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.models.registry import build_model

    lm_npz, lm_json = os.path.join(workdir, "lm.npz"), os.path.join(workdir, "lm.json")
    # a unit-variance tied embedding gives a random LM logits of scale
    # sqrt(d_model) = 16, which swamp the model even at weight 0.1; scaled
    # down to unit logits it acts like a weak LM: it moves scores, not all ids
    d_model = ANCHOR_LM_CFG["d_model"]
    compat.save_npz(lm_npz, seeded_params(build_model(ANCHOR_LM_CFG), seed=11,
                                          embedding_std=d_model ** -0.5))
    with open(lm_json, "w") as f:
        json.dump(ANCHOR_LM_CFG, f)
    lm_args = ("-lm", lm_npz, "--lm_cfg", lm_json)

    out = os.path.join(workdir, "decode_lmw0")
    cer, one, two = anchor_decode("phase4 anchor f32 + random transformer LM, -lmw 0.0",
                                  data, out, "float32", (*lm_args, "-lmw", "0.0"))
    if two == 0 or one != 0:
        raise AssertionError("the LM-fusion decode must go through the two-head kernel only: "
                             f"one-head launches {one}, two-head launches {two}")
    if cer > ANCHOR_CER_LIMIT:
        raise AssertionError(f"anchor f32 CER {cer}% at lm weight 0 above {ANCHOR_CER_LIMIT}% "
                             "(the fused score is then the model's own)")
    log(f"phase4 anchor f32 at lm weight 0 through the two-head kernel: CER {cer}% <= "
        f"{ANCHOR_CER_LIMIT}% ok, {two} two-head launches, 0 one-head launches")

    out = os.path.join(workdir, "decode_lmw01")
    cer, one, two = anchor_decode("phase4 anchor f32 + random transformer LM, -lmw 0.1",
                                  data, out, "float32", (*lm_args, "-lmw", "0.1"))
    log(f"phase4 -lmw 0.1: CER {cer}% (not gated: the LM is untrained)")
    out = os.path.join(workdir, "decode_resc")
    anchor_decode("phase4 anchor f32 + random transformer LM, -lmw 0.1 -lm_resc 0.1",
                  data, out, "float32", (*lm_args, "-lmw", "0.1", "-lm_resc", "0.1"))
    log(f"phase4 -lm_resc 0.1: n-best scores sorted for {nbest_scores_sorted(out)} utterances ok")
    return two


# ---------------------------------------------------------------- phase 5
def phase_flagship_lm():
    model32 = seeded_model(FLAGSHIP_CFG, torch.float32, seed=0)
    small_input_check("phase5 flagship f32 + transformer LM (ancestry-map caches)", model32,
                      seeded_model(FLAGSHIP_LM_CFG, torch.float32, seed=1))
    small_input_check("phase5 flagship f32 + LSTM LM (gathered state)", model32,
                      seeded_model(LSTM_LM_CFG, torch.float32, seed=2))
    del model32
    model = seeded_model(FLAGSHIP_CFG, torch.bfloat16, seed=0)
    lm = seeded_model(FLAGSHIP_LM_CFG, torch.bfloat16, seed=1)
    one, two = worst_case_decode("phase5 flagship + transformer LM shallow fusion", model, lm)
    max_len = WORST_CASE["max_len"]
    if two != max_len or one != 0:
        raise AssertionError(f"expected one two-head kernel launch per decode step ({max_len}) "
                             f"and no one-head launch, counted {two} and {one}")
    # what fusion costs: the host clock drifts between phases, so the decode
    # without and with the LM run in turns on the same model and inputs
    run_plain, run_lm = worst_case_run(model), worst_case_run(model, lm)
    pairs = [(host_seconds(run_plain), host_seconds(run_lm)) for _ in range(7)]
    mid = len(pairs) // 2
    plain_s = sorted(p for p, _ in pairs)[mid]
    lm_s = sorted(f for _, f in pairs)[mid]
    diff_s = sorted(f - p for p, f in pairs)[mid]
    log(f"phase5 cost of LM fusion, {len(pairs)} alternating pairs: median without LM "
        f"{plain_s:.3f} s, with LM {lm_s:.3f} s, median difference {diff_s:+.3f} s per batch "
        f"(pairs {[(round(p, 3), round(f, 3)) for p, f in pairs]}) [{card_line()}]")
    return two


def kernel_record(name, source, replaces, launches, max_err, timing):
    kern, plain, bound, bound_by = timing
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_err, "ms": kern, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}


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
    max_err2, timings2 = phase_kernel2()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        data = phase_anchor(workdir)
        launches = phase_flagship()
        phase_anchor_lm(workdir, data)
    launches2 = phase_flagship_lm()

    # launches: each kernel's count on its own main path (phase 3 without an
    # LM, phase 5 with one); times at the flagship bf16 beam-step shape
    record = {"kernels": [
        kernel_record("project_logp_topk", "opentransformer_tpu_torch/csrc/project_topk.cu",
                      "opentransformer_tpu/ops/project_topk.py:96", launches, max_err,
                      timings["flagship bf16"]),
        kernel_record("project2_logp_topk", "opentransformer_tpu_torch/csrc/project2_topk.cu",
                      "opentransformer_tpu/ops/project_topk.py:190", launches2, max_err2,
                      timings2["flagship bf16"]),
    ]}
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
