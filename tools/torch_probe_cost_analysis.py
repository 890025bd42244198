#!/usr/bin/env python
"""FLOPs of one flagship training update on the PyTorch port, and its MFU
(counterpart of ``tools/probe_cost_analysis.py``).

Counts, with ``torch.utils.flop_counter.FlopCounterMode``, the floating-point
operations of the flagship update (``opentransformer_tpu_torch/conf/
flagship_bench.json``: B64 x T512 x U32, bf16 autocast, forward, backward,
clip and Adam, as the trainer runs it) three ways:

  single         one update
  steps_per_exec 20 updates with ``train.steps_per_exec`` 20
  accum4         one update of ``accum_steps`` 4 micro-batches

Convention: eager PyTorch runs, and the counter counts, every executed
operation, so the 20-update program counts 20 updates and the accumulated
update 4 micro-batches (ratios 20 and 4; XLA's ``cost_analysis`` counts a
scan body once, ratio 1.0). The counter counts the products (matmuls,
batched matmuls, convolutions), not the elementwise operations, which XLA
counts too.

Beside the count it prints the hand roofline of the JAX tool's docstring,
2 x parameters x tokens for each stack's forward (the encoder's parameters
over B x T/4 frames, the decoder's over B x (U + 1) tokens) times 3 for the
forward and the backward, and it times ``--time-iters`` single updates
(host clock ending in a synchronise, after a warm-up): on the card the
model FLOP utilisation is the single count over that time over the bf16
dense peak of 989 TFLOP/s (H100 SXM). It prints one JSON line. It runs on
the card unless ``--device cpu`` is given; a CPU run's time is CPU time and
it reports no MFU.

    python tools/torch_probe_cost_analysis.py [-b 64] [-t 512] [-u 32] [--time-iters 10]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from opentransformer_tpu_torch import profiling  # noqa: E402
from opentransformer_tpu_torch.utils import resolve_device  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_profile_train import batch_source, build_trainer  # noqa: E402

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core rate, FLOP/s
STEPS_PER_EXEC = 20
ACCUM = 4


def count(trainer, next_batch, updates: int) -> int:
    """FLOPs of ``updates`` updates of ``trainer.accum_steps`` micro-batches."""
    with FlopCounterMode(display=False) as fc:
        for _ in range(updates):
            for _ in range(trainer.accum_steps):
                trainer.micro_step(next_batch())
            trainer.update()
    return int(fc.get_total_flops())


def hand_roofline(model, b: int, t: int, u: int) -> float:
    """3 x 2 x (encoder parameters x B·T/4 + decoder parameters x B·(U + 1))."""
    enc = sum(p.numel() for n, p in model.named_parameters()
              if n.startswith(("frontend", "encoder")))
    dec = sum(p.numel() for p in model.parameters()) - enc
    return 3.0 * 2.0 * (enc * b * (t // 4) + dec * b * (u + 1))


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-b", type=int, default=64)
    ap.add_argument("-t", type=int, default=512)
    ap.add_argument("-u", type=int, default=32)
    ap.add_argument("--time-iters", type=int, default=10, help="timed single updates")
    ap.add_argument("--config", default=profiling.FLAGSHIP_BENCH,
                    help="JSON with the model and train sections (default: the flagship's)")
    ap.add_argument("--seed", type=int, default=0, help="the random weights' seed")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    b, t, u = args.b, args.t, args.u
    out = {"device": device.type, "b": b, "t": t, "u": u,
           "convention": "eager: every executed op counted (products only; XLA also "
                         "counts elementwise ops and counts a scan body once)"}
    trainer = build_trainer(device, 1, args.seed, args.config)
    next_batch = batch_source(b, t, u, device, devgen=True,
                              vocab=trainer.model.decoder.vocab_size)
    out["single"] = count(trainer, next_batch, 1)
    spe = build_trainer(device, 1, args.seed, args.config)
    spe.steps_per_exec = STEPS_PER_EXEC
    out["steps_per_exec20"] = count(spe, next_batch, STEPS_PER_EXEC)
    del spe
    acc = build_trainer(device, ACCUM, args.seed, args.config)
    out["accum4"] = count(acc, next_batch, 1)
    del acc
    out["steps_per_exec20/single"] = out["steps_per_exec20"] / out["single"]
    out["accum4/single"] = out["accum4"] / out["single"]
    out["parameters"] = sum(p.numel() for p in trainer.model.parameters())
    out["hand_roofline"] = hand_roofline(trainer.model, b, t, u)
    out["single/hand_roofline"] = out["single"] / out["hand_roofline"]

    if args.time_iters > 0:
        step = lambda: (trainer.micro_step(next_batch()), trainer.update())  # noqa: E731
        step()  # warm-up
        profiling.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(args.time_iters):
            step()
        profiling.synchronize(device)
        secs = (time.perf_counter() - t0) / args.time_iters
        if device.type == "cuda":
            out["update_ms"] = secs * 1e3
            out["mfu"] = out["single"] / secs / PEAK_BF16
            out["peak_flops"] = PEAK_BF16
            out["card"] = profiling.card_line()
        else:
            out["cpu_update_ms"] = secs * 1e3
    print(json.dumps(out, indent=2))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
