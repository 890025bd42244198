#!/usr/bin/env python
"""Where a training update's time goes on the PyTorch port
(counterpart of ``tools/profile_train.py``).

Runs the flagship update (``opentransformer_tpu_torch/conf/flagship_bench.json``:
its model and its ``train`` section, bf16 autocast over float32 weights, as
the trainer runs it: forward, backward, clip, Adam) ``--iters`` updates a
call, two calls, under ``torch.profiler`` after a warm-up call, and prints:

  * the total device self time (kernels, copies and memsets) and the host
    time of the window, ending in a synchronise;
  * the breakdown by category, a fixed mapping of kernel names
    (``opentransformer_tpu_torch/profiling.py``): gemm, elementwise,
    reduction, copy/memset, the port's kernels 1-3, other; the categories
    sum to the total;
  * the top ``--top`` kernels by device self time, with their launches;
  * the device's idle share over the window;
  * the trainer's spans (``profiling.span``) an update: count and host
    milliseconds of each;
  * one JSON line of the figures.

Features are host arrays copied to the card each micro-batch (B x T x 40
with U target tokens, seeded), or with ``--devgen`` drawn on the card each
micro-batch from an explicit ``torch.Generator`` (the bench's devgen
program; ``--accum`` micro-batches an update). The chrome trace is written
to ``--trace-dir``/trace.json; ``--parse-only`` re-reads it (its idle share
is then over the span of its device events). A trace without device time
fails the run. On the CPU (``--device cpu``) the profile is the operators'
CPU self time, labelled ``cpu``.

    python tools/torch_profile_train.py [-b 16] [-t 512] [-u 32] [--iters 8]
        [--devgen] [--accum 1] [--top 30] [--trace-dir DIR] [--parse-only]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from opentransformer_tpu_torch import profiling  # noqa: E402
from opentransformer_tpu_torch.models.registry import build_model  # noqa: E402
from opentransformer_tpu_torch.train.trainer import Trainer  # noqa: E402
from opentransformer_tpu_torch.utils import resolve_device  # noqa: E402

CALLS = 2


def build_trainer(device, accum: int = 1, seed: int = 0,
                  config: str = profiling.FLAGSHIP_BENCH) -> Trainer:
    """The flagship model and a trainer with the flagship's train section
    in bf16 autocast (or those of another ``{"model", "train"}`` JSON)."""
    model_cfg, train_cfg = profiling.flagship_bench(config)
    torch.manual_seed(seed)
    model = build_model(model_cfg, dtype=torch.float32, device=device).train()
    cfg = dict(train_cfg, accum_steps=accum, dtype="bfloat16")
    return Trainer(cfg, model, None, torch.Generator(device=device).manual_seed(seed),
                   log_interval=10 ** 9)


def batch_source(b: int, t: int, u: int, device, devgen: bool, seed: int = 2,
                 vocab: int = 4233):
    """``next_batch()`` → one micro-batch (utt_ids, inputs, targets):
    host features, or features drawn on the card (``devgen``); target ids
    in [3, min(4000, vocab))."""
    rng = np.random.default_rng(seed)
    tgt = np.ones((b, u + 2), np.int32)
    tgt[:, 1:-1] = rng.integers(3, min(4000, vocab), (b, u))
    tlen = np.full((b,), u + 1, np.int32)
    if devgen:
        gen = torch.Generator(device=device).manual_seed(seed)
        targets = {"targets": torch.as_tensor(tgt, dtype=torch.long, device=device),
                   "targets_length": torch.as_tensor(tlen, dtype=torch.long, device=device)}
        mask = torch.ones(b, t, dtype=torch.bool, device=device)

        def next_batch():
            feats = torch.randn(b, t, 40, generator=gen, device=device)
            return None, {"inputs": feats, "mask": mask}, targets
    else:
        targets = {"targets": tgt, "targets_length": tlen}
        mask = np.ones((b, t), bool)

        def next_batch():
            feats = rng.normal(size=(b, t, 40)).astype(np.float32)
            return None, {"inputs": feats, "mask": mask}, targets
    return next_batch


def run_updates(trainer: Trainer, next_batch, updates: int) -> None:
    for _ in range(updates):
        for _ in range(trainer.accum_steps):
            trainer.micro_step(next_batch())
        trainer.update()


def report(summary: dict, top: int, clock: str) -> None:
    total = summary[f"{clock}_self_ms" if clock == "cpu" else "device_ms"]
    label = "CPU self time" if clock == "cpu" else "device self time"
    print(f"\ntotal {label}: {total:.2f} ms ({len(summary['top'])} of the top ops listed)")
    print("\nby category:")
    for cat, ms in summary["by_category"].items():
        print(f"  {ms:9.2f} ms  {100 * ms / max(total, 1e-12):5.1f}%  {cat}")
    print(f"\ntop {top} ops by {label}:")
    for name, ms, n in summary["top"][:top]:
        print(f"  {ms:9.3f} ms  {100 * ms / max(total, 1e-12):5.1f}%  {name[:90]} x{n}")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-b", type=int, default=16)
    ap.add_argument("-t", type=int, default=512)
    ap.add_argument("-u", type=int, default=32)
    ap.add_argument("--iters", type=int, default=8, help="updates a call (two calls traced)")
    ap.add_argument("--accum", type=int, default=1,
                    help="micro-batches an update (--devgen only)")
    ap.add_argument("--devgen", action="store_true",
                    help="draw the features on the card each micro-batch")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--trace-dir", default=os.path.join(tempfile.gettempdir(),
                                                        "ot_torch_train_trace"))
    ap.add_argument("--parse-only", action="store_true",
                    help="skip running; summarize --trace-dir/trace.json")
    ap.add_argument("--config", default=profiling.FLAGSHIP_BENCH,
                    help="JSON with the model and train sections (default: the flagship's)")
    ap.add_argument("--seed", type=int, default=0, help="the random weights' seed")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def main(argv=None) -> int:
    ap = build_argparser()
    args = ap.parse_args(argv)
    if args.accum > 1 and not args.devgen:
        ap.error("--accum requires --devgen")
    path = os.path.join(args.trace_dir, "trace.json")
    record = {"b": args.b, "t": args.t, "u": args.u, "iters": args.iters,
              "accum": args.accum, "devgen": args.devgen}
    if args.parse_only:
        with open(path, "r", encoding="utf-8") as f:
            summary = profiling.summarize_trace(json.load(f), args.top)
        report(summary, args.top, "device")
        record.update(summary, parse_only=True, trace=path)
        print(json.dumps(record), flush=True)
        return 0

    device = resolve_device(args.device)
    record["device"] = device.type
    trainer = build_trainer(device, args.accum, args.seed, args.config)
    next_batch = batch_source(args.b, args.t, args.u, device, args.devgen,
                              vocab=trainer.model.decoder.vocab_size)
    run_updates(trainer, next_batch, args.iters)  # warm-up call
    os.makedirs(args.trace_dir, exist_ok=True)
    updates = CALLS * args.iters
    if device.type == "cuda":
        with profiling.Window(device, keep=path) as w:
            run_updates(trainer, next_batch, updates)
        summary = profiling.summarize_trace(w.trace, args.top)
        summary.update(host_ms=w.seconds * 1e3, busy_ms=w.busy_ms, idle_share=w.idle_share,
                       device_ms_per_update=summary["device_ms"] / updates,
                       host_ms_per_update=w.seconds * 1e3 / updates)
        print(f"device: {torch.cuda.get_device_name(device)} [{profiling.card_line()}]")
        report(summary, args.top, "device")
        print(f"\nwindow: {w.seconds * 1e3:.2f} ms host for {updates} updates "
              f"({w.seconds * 1e3 / updates:.3f} ms an update), device busy "
              f"{w.busy_ms:.2f} ms, idle share {w.idle_share:.3f}")
        record["card"] = profiling.card_line()
        spans = w.spans
    else:
        import time

        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        profiling.reset()  # count only the spans recorded under this profile
        t0 = time.perf_counter()
        with prof:
            run_updates(trainer, next_batch, updates)
        secs = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        summary = profiling.summarize_cpu(prof, args.top)
        summary.update(cpu_ms=secs * 1e3, cpu_ms_per_update=secs * 1e3 / updates)
        print("device: cpu (CPU times; no device in this run)")
        report(summary, args.top, "cpu")
        spans = profiling.spans()
    record["spans"] = profiling.span_totals(spans, updates)
    print(f"\nthe trainer's spans, an update: "
          f"{profiling.format_span_totals(record['spans'], profiling.clock(device))}")
    print(f"trace written to {path} ({args.iters} updates/call x {CALLS} calls, B{args.b}"
          f"{f'x{args.accum}accum' if args.accum > 1 else ''} T{args.t}"
          f"{' devgen' if args.devgen else ''})")
    losses = [x for r in trainer.history for x in r["losses"]]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite training loss: {losses}")
    record.update(summary, updates=updates, trace=path, last_loss=losses[-1])
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
