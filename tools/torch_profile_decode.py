#!/usr/bin/env python
"""Decode-path cost decomposition of the PyTorch port
(counterpart of ``tools/profile_decode.py``).

Times the flagship beam-5 decode (``opentransformer_tpu_torch/conf/
flagship_bench.json``: d256, 12 encoder and 6 decoder blocks, V=4233; bf16,
random weights from ``--seed``, B=512 x 500 frames x 40) in pieces:

  encode        frontend + 12-block encoder on [B, T, 40]
  search N      the beam search alone on a precomputed memory, ``max_len``
                N with EOS disabled (every step runs); the slope between
                N=24 and N=4 is the time of a decode step with the loop's
                constant removed
  surgery runs  the same search with one component shrunk (``d_ff=256``,
                ``vocab=512``, ``dec_blocks=3``), timed in ``PAIRS``
                alternating pairs with the full model's search, each call
                its own window; the median of the pairs' differences
                attributes a step's cost to the component (``--quick``
                skips them)

The search is the one the eval CLI runs (``recognize.base.make_memory_search``),
and each call gets its own perturbed copy of the memory. Every figure is
the mean over ``--iters`` calls after a warm-up call (the surgery: the
medians over ``PAIRS`` pairs): the host clock of the window, ending in
``torch.cuda.synchronize()``, and beside it the device time of the same
window from ``torch.profiler`` (kernels, copies and memsets summed). The launches of kernel 1 (``project_logp_topk``) and
kernel 2 (``project2_logp_topk``) are counted a call.

  --micro      each per-step op at the step's shapes in a 24-step chained
               loop timed with CUDA events: the QKV and GLU FFN products,
               the vocabulary projection through kernel 1, layer norm,
               cross attention, the ancestral self attention, the cache
               writes, the beam's book-keeping
  --conformer  matched-batch encode and search for the transformer and the
               conformer encoder at B=256
  --lm         the search without an LM and with LMs of 0, 1 and 6 blocks
               fused through kernel 2, the per-step slope of each and its
               attribution (every variant's searches warmed before timing)

It prints the JAX tool's text lines, then one JSON line of the figures.
It runs on the card unless ``--device cpu`` is given; a CPU run's times are
host times labelled ``cpu`` and it has no device time.

    python tools/torch_profile_decode.py [--quick | --micro | --conformer | --lm]
        [-b 512] [--frames 500] [--iters 3] [--seed 0] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from opentransformer_tpu_torch import profiling  # noqa: E402
from opentransformer_tpu_torch.config import set_key  # noqa: E402
from opentransformer_tpu_torch.models.registry import build_model  # noqa: E402
from opentransformer_tpu_torch.ops.project_topk import (  # noqa: E402
    project2_logp_topk, project_logp_topk)
from opentransformer_tpu_torch.recognize.base import make_memory_search  # noqa: E402
from opentransformer_tpu_torch.utils import resolve_device  # noqa: E402

BEAM = 5
STEPS = (24, 4)
PAIRS = 7  # (full, surgery) rounds: the host clock's outliers need a median
MICRO_STEPS = 24
SURGERY = (("d_ff=256", "decoder.d_ff=256"),
           ("vocab=512", "decoder.vocab_size=512"),
           ("dec_blocks=3", "decoder.n_blocks=3"))
# the conformer geometry of bench.py's matched-batch row (the conformer's
# depth key is "nblocks", as in the reference configs)
CONFORMER_ENCODER = {"d_model": 256, "n_heads": 4, "d_ff": 2048, "nblocks": 12,
                     "residual_dropout": 0.1, "relative_positional": True}
LM_BLOCKS = (("LM-0L", 0), ("LM-1L", 1), ("LM-6L", 6))


def lm_cfg(n_blocks: int) -> dict:
    """The LM of bench.py's lm_fusion row at ``n_blocks`` blocks."""
    return {"type": "transformer_lm", "vocab_size": 4233, "d_model": 256, "n_heads": 4,
            "d_ff": 2048, "num_blocks": n_blocks, "residual_dropout": 0.0}


def model_cfg(assignments=(), encoder: str = "transformer") -> dict:
    """The tools' flagship model config with ``SECTION.KEY=VALUE``
    ``assignments`` set, or with the conformer encoder of the matched-batch
    comparison."""
    cfg = copy.deepcopy(profiling.flagship_bench()[0])
    for assignment in assignments:
        set_key(cfg, assignment)
    if encoder == "conformer":
        cfg = dict(cfg, encoder_type="conformer", encoder=dict(CONFORMER_ENCODER))
    return cfg


def build(cfg: dict, device, seed: int, dtype=torch.bfloat16):
    torch.manual_seed(seed)
    return build_model(cfg, dtype=dtype, device=device)


class Runner:
    """The tool's state: device, sizes, the JSON record."""

    def __init__(self, args):
        self.device = resolve_device(args.device)
        self.batch, self.frames, self.iters, self.seed = (args.batch, args.frames, args.iters,
                                                          args.seed)
        self.clock = profiling.clock(self.device)
        self.record = {"device": self.device.type, "batch": self.batch, "frames": self.frames,
                       "beam": BEAM, "iters": self.iters, "pairs": PAIRS, "card": profiling.card_line()
                       if self.device.type == "cuda" else None}

    def feats(self, rng, b=None):
        b = b or self.batch
        x = torch.as_tensor(rng.normal(size=(b, self.frames, 40)), dtype=torch.float32)
        return x.to(self.device), torch.ones(b, self.frames, dtype=torch.bool,
                                             device=self.device)

    def timed(self, fn, make_inputs) -> dict:
        """Warm once, then the mean over ``iters`` calls on distinct inputs:
        {<clock>_ms, device_ms, k1, k2 (launches a call, warm-up included)}."""
        k0 = (project_logp_topk.launches, project2_logp_topk.launches)
        fn(*make_inputs(0))
        args = [make_inputs(i + 1) for i in range(self.iters)]
        with profiling.Window(self.device) as w:
            for a in args:
                fn(*a)
        calls = self.iters + 1
        out = {f"{self.clock}_ms": w.seconds / self.iters * 1e3,
               "k1": (project_logp_topk.launches - k0[0]) / calls,
               "k2": (project2_logp_topk.launches - k0[1]) / calls}
        if w.device_ms is not None:
            out["device_ms"] = w.device_ms / self.iters
        return out

    def window(self, fn, args) -> dict:
        """One call in its own window: {<clock>_ms, device_ms}."""
        with profiling.Window(self.device) as w:
            fn(*args)
        out = {f"{self.clock}_ms": w.seconds * 1e3}
        if w.device_ms is not None:
            out["device_ms"] = w.device_ms
        return out

    def paired(self, a, b) -> dict:
        """The calls ``a`` and ``b`` ((fn, make_inputs) each) alternated:
        a warm-up call of each, then ``PAIRS`` rounds of a call of ``a``
        and one of ``b``, each in its own window. On each clock: the mean
        of each, and the median, least and largest of the rounds'
        differences a - b."""
        (fa, ia), (fb, ib) = a, b
        fa(*ia(0))
        fb(*ib(0))
        ta, tb = [], []
        for i in range(PAIRS):
            ta.append(self.window(fa, ia(i + 1)))
            tb.append(self.window(fb, ib(i + 1)))
        out = {"pairs": PAIRS}
        for k in ta[0]:
            diffs = [x[k] - y[k] for x, y in zip(ta, tb)]
            out[k] = {"a": float(np.mean([x[k] for x in ta])),
                      "b": float(np.mean([y[k] for y in tb])),
                      "delta_median": float(np.median(diffs)),
                      "delta_min": float(min(diffs)), "delta_max": float(max(diffs))}
        return out

    def fmt(self, t: dict) -> str:
        s = f"{t[f'{self.clock}_ms']:8.2f} ms {self.clock}"
        if "device_ms" in t:
            s += f" | {t['device_ms']:8.2f} ms device"
        return s

    def encode(self, model, rng, b=None) -> tuple[dict, torch.Tensor, torch.Tensor]:
        @torch.inference_mode()
        def run(x, m):
            return model.encode(x, m)

        t = self.timed(run, lambda i: self.feats(rng, b))
        memory, memory_mask = run(*self.feats(rng, b))
        return t, memory, memory_mask

    def search_call(self, model, memory, memory_mask, max_len: int, lm=None, seed=None):
        """(the CLI's search on a memory, the maker of each call's
        perturbed copy of the memory)."""
        search = make_memory_search(model, BEAM, max_len, eos_id=-1, lm=lm)
        rng = np.random.default_rng(max_len * 7 + 13 if seed is None else seed)

        def inputs(i):
            eps = torch.as_tensor(rng.normal(size=(1, 1, memory.shape[-1])) * 1e-3)
            return memory + eps.to(memory.device, memory.dtype), memory_mask

        return (lambda mem, mm: search(mem, mm)), inputs

    def search(self, model, memory, memory_mask, max_len: int, lm=None) -> dict:
        t = self.timed(*self.search_call(model, memory, memory_mask, max_len, lm=lm))
        t["max_len"] = max_len
        return t


def per_step(times: dict) -> dict:
    """The slope between the two search lengths, on each clock."""
    a, b = times[STEPS[0]], times[STEPS[1]]
    return {k: (a[k] - b[k]) / (STEPS[0] - STEPS[1]) for k in a
            if k.endswith("_ms")}


def default_run(r: Runner, quick: bool) -> None:
    cfg = model_cfg()
    model = build(cfg, r.device, r.seed)
    t_enc, memory, memory_mask = r.encode(model, np.random.default_rng(1))
    print(f"encode                 : {r.fmt(t_enc)}", flush=True)
    r.record["encode"] = t_enc
    times = {}
    for max_len in STEPS:
        times[max_len] = r.search(model, memory, memory_mask, max_len)
        print(f"search max_len={max_len:3d} {'':12s}: {r.fmt(times[max_len])} "
              f"(kernel-1 launches a call {times[max_len]['k1']:.0f})", flush=True)
    slope = per_step(times)
    print(f"  -> per-step (slope)  : " + " | ".join(
        f"{v:8.3f} ms {k[:-3]}" for k, v in slope.items()), flush=True)
    r.record.update(searches=[times[n] for n in STEPS], per_step=slope)
    if quick:
        return
    r.record["surgery"] = []
    full = r.search_call(model, memory, memory_mask, STEPS[0], seed=99)
    for label, assignment in SURGERY:
        mdl = build(model_cfg([assignment]), r.device, r.seed)
        _, mem2, mm2 = r.encode(mdl, np.random.default_rng(1))
        t = r.paired(full, r.search_call(mdl, mem2, mm2, STEPS[0], seed=99))
        print(f"search 24 {label:15s}: " + " | ".join(
            f"{v['b']:8.2f} ms {k[:-3]} (full {v['a']:8.2f}; saved, median of {t['pairs']} "
            f"pairs {v['delta_median']:+8.2f} = {v['delta_median'] / v['a'] * 100:+6.1f}%, "
            f"range {v['delta_min']:+.2f} .. {v['delta_max']:+.2f})"
            for k, v in t.items() if k.endswith("_ms")), flush=True)
        r.record["surgery"].append(dict(t, label=label))
        del mdl, mem2, mm2


def conformer_run(r: Runner, b: int = 256) -> None:
    b = min(b, r.batch)
    r.record["conformer"] = []
    for enc in ("transformer", "conformer"):
        model = build(model_cfg(encoder=enc), r.device, r.seed)
        t_enc, memory, memory_mask = r.encode(model, np.random.default_rng(3), b)
        t_search = r.search(model, memory, memory_mask, STEPS[0])
        k = f"{r.clock}_ms"
        audio = b * r.frames * 0.01
        rtfx = audio / ((t_enc[k] + t_search[k]) / 1e3)
        print(f"{enc:12s} B{b}: encode {r.fmt(t_enc)} | search24 {r.fmt(t_search)} | "
              f"RTFx {rtfx:8.0f} ({r.clock} clock)", flush=True)
        r.record["conformer"].append({"encoder": enc, "batch": b, "encode": t_enc,
                                      "search24": t_search, f"rtfx_{r.clock}": rtfx})
        del model, memory, memory_mask


def lm_run(r: Runner) -> None:
    model = build(model_cfg(), r.device, r.seed)
    _, memory, memory_mask = r.encode(model, np.random.default_rng(1))
    results, r.record["lm"] = {}, []
    variants = [("no-LM", None)] + [(label, n) for label, n in LM_BLOCKS]
    for label, n_blocks in variants:
        lm = None if n_blocks is None else build(lm_cfg(n_blocks), r.device, r.seed + 1)
        times = {}
        for max_len in STEPS:  # each variant's searches warm inside timed()
            times[max_len] = r.search(model, memory, memory_mask, max_len, lm=lm)
            print(f"search B{r.batch} max_len={max_len:3d} {label:6s}: {r.fmt(times[max_len])} "
                  f"(launches a call: kernel 1 {times[max_len]['k1']:.0f}, kernel 2 "
                  f"{times[max_len]['k2']:.0f})", flush=True)
        results[label] = per_step(times)
        print(f"  -> per-step ({label})  : " + " | ".join(
            f"{v:8.3f} ms {k[:-3]}" for k, v in results[label].items()), flush=True)
        r.record["lm"].append({"label": label, "num_blocks": n_blocks,
                               "searches": [times[n] for n in STEPS],
                               "per_step": results[label]})
        del lm
    attribution = {}
    for k in results["no-LM"]:
        base, zero, one, six = (results[v][k] for v in ("no-LM", "LM-0L", "LM-1L", "LM-6L"))
        attribution[k] = {"fusion_per_step": six - base, "ratio_6L": six / base,
                          "second_head_no_cache": zero - base, "first_block": one - zero,
                          "per_block": (six - one) / 5}
        print(f"\n[{k[:-3]} clock] fusion overhead per step : {(six - base):8.3f} ms "
              f"({six / base:.2f}x no-LM)")
        print(f"  second head + embedding, NO LM cache (0L - none): {zero - base:8.3f} ms")
        print(f"  first block's cache + attn (1L - 0L)            : {one - zero:8.3f} ms")
        print(f"  per-LM-block cost ((6L - 1L)/5)                 : {(six - one) / 5:8.3f} ms")
    r.record["lm_attribution"] = attribution


def micro_run(r: Runner) -> None:
    """Each decode-step op at the step's shapes, ``MICRO_STEPS`` chained
    calls a measurement (CUDA events on the card, the host clock on the
    CPU), in µs a step."""
    dev, bf = r.device, torch.bfloat16
    b, k, h, dh, d, u, v, dff = r.batch, BEAM, 4, 64, 256, 25, 4233, 2048
    t = r.frames // 4
    n = b * k
    g = torch.Generator().manual_seed(0)

    def arr(*shape, dtype=bf):
        return (torch.randn(*shape, generator=g) * 0.05).to(dev, dtype)

    def loop_us(f, x0):
        def run(x):
            for _ in range(MICRO_STEPS):
                x = f(x)
            return x
        run(x0)
        profiling.synchronize(dev)
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for i in range(r.iters):
                run(x0)
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for i in range(r.iters):
                run(x0)
            secs = time.perf_counter() - t0
        return secs / r.iters / MICRO_STEPS * 1e6

    x = arr(n, d)
    wqkv, wff1, wff2, wv, bv = arr(d, 3 * d), arr(d, 2 * dff), arr(dff, d), arr(v, d), arr(v)
    gamma, beta = arr(d, dtype=torch.float32), arr(d, dtype=torch.float32)
    ck, cv = arr(b, h, t, dh), arr(b, h, t, dh)
    sk, sv = arr(n, h, u, dh), arr(n, h, u, dh)
    src = torch.arange(k, device=dev).repeat(b, u, 1).transpose(1, 2).contiguous()

    from opentransformer_tpu_torch.models.modules import ancestral_decode_context

    def vocab(c):
        vals, _ = project_logp_topk(c, wv, bv, k)
        return c * 0.999 + vals.mean().to(c.dtype)

    def ln(c):
        y = torch.nn.functional.layer_norm(c.float(), (d,), gamma, beta, 1e-5)
        return y.to(c.dtype) * 0.999

    def cross(c):
        q = c.reshape(b, k, h, dh).float()
        s = torch.einsum("bkhd,bhtd->bkht", q, ck.float()) / 8.0
        w = torch.softmax(s, -1).to(bf)
        ctx = torch.einsum("bkht,bhtd->bkhd", w.float(), cv.float())
        return ctx.to(bf).reshape(n, d) * 0.999

    def ancestral(c):
        ctx = ancestral_decode_context(c.reshape(n, h, 1, dh), sk, sv, u - 1, src)
        return ctx.reshape(n, d) * 0.999

    def cache_write(c):
        cache, step = c
        cache[:, :, step % u] = cache[:, :, 0] * 0.999
        return cache, step + 1

    sc = arr(b, k, dtype=torch.float32)
    tok = torch.ones(n, u, dtype=torch.long, device=dev)

    def book(c):
        scores, toks = c
        best, flat = torch.topk((scores[:, :, None] + scores[:, None, :]).reshape(b, k * k), k)
        parent = flat // k
        rows = (torch.arange(b, device=dev)[:, None] * k + parent).reshape(-1)
        return best * 0.999, toks[rows]

    ops = [("qkv_matmul x6", lambda c: (c @ wqkv)[:, :d] * 0.999, x),
           ("ffn_glu x6", lambda c: (lambda y: (y[:, :dff] * torch.sigmoid(y[:, dff:])) @ wff2)(
               c @ wff1) * 0.999, x),
           ("vocab+logsoftmax+topk x1", vocab, x),
           ("layernorm x18", ln, x),
           ("cross_attn_math x6", cross, arr(n, d)),
           ("ancestral_self_attn x6", ancestral, arr(n, d)),
           ("cache_write x12", cache_write, (sk.clone(), 0)),
           ("beam_bookkeeping x1", book, (sc, tok))]
    r.record["micro"] = {}
    with torch.inference_mode():
        for name, f, x0 in ops:
            us = loop_us(f, x0)
            label = "device" if dev.type == "cuda" else "cpu"
            print(f"micro {name:28s}: {us:9.1f} us/step ({label})", flush=True)
            r.record["micro"][name] = {f"{label}_us": us}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="skip the surgery runs")
    ap.add_argument("--micro", action="store_true", help="the per-step ops alone")
    ap.add_argument("--conformer", action="store_true",
                    help="matched-batch transformer vs conformer decomposition")
    ap.add_argument("--lm", action="store_true", help="LM shallow-fusion attribution")
    ap.add_argument("-b", "--batch", type=int, default=512)
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--iters", type=int, default=3, help="timed calls a measurement")
    ap.add_argument("--seed", type=int, default=0, help="the random weights' seed")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    r = Runner(args)
    mode = ("micro" if args.micro else "conformer" if args.conformer
            else "lm" if args.lm else "quick" if args.quick else "default")
    r.record["mode"] = mode
    if args.micro:
        micro_run(r)
    elif args.conformer:
        conformer_run(r)
    elif args.lm:
        lm_run(r)
    else:
        default_run(r, args.quick)
    if r.record["card"]:
        print(r.record["card"])
    print(json.dumps(r.record), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
