#!/usr/bin/env python
"""Multi-stream serving latency of the PyTorch port
(counterpart of ``tools/stream_latency.py``).

Drives the batched multi-stream CTC server (``recognize/multistream.py``,
the engine of ``cli/serve.py --streaming``) with N concurrent streams at the
flagship encoder geometry (a d256 x 12-block chunked encoder, chunk 16,
left 4, vocab 4233, bf16, random weights from ``--seed``) and reports the
per-tick latency percentiles, per-stream RTF and aggregate real-time
capacity. A tick is a chunk of audio (640 ms), so ``--seconds`` sets the
number of ticks a run samples: 10 s give 16, 200 s give 313. The
sustainable-streams line extrapolates the p50 tick linearly in the rows;
a saturated run at that many streams measures it.

Two drive modes:

  * saturated (default): every stream's audio is buffered up front and
    ticks fire back to back; each tick advances every stream one chunk in
    one fused step. This measures the server's capacity.
  * paced (``--paced``): frames arrive in real time (a chunk's duration a
    chunk) and a tick fires as soon as any stream has a full chunk. This
    measures the latency a live client sees a PARTIAL.

Each tick ends in the greedy CTC step's host read of its ids, so a tick's
host time covers its device work. It prints the JAX tool's lines, then
one JSON line with kernel 1's launches (one a tick: the greedy top-1 of the
fused CTC head) beside the ticks. It runs on the card unless ``--device
cpu`` is given; a CPU run's times are CPU times.

    python tools/torch_stream_latency.py [-n 16] [--seconds 10] [--paced]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from opentransformer_tpu_torch import profiling  # noqa: E402
from opentransformer_tpu_torch.models.registry import build_model  # noqa: E402
from opentransformer_tpu_torch.ops.project_topk import project_logp_topk  # noqa: E402
from opentransformer_tpu_torch.recognize.multistream import MultiStreamCTC  # noqa: E402
from opentransformer_tpu_torch.utils import resolve_device  # noqa: E402

# flagship-scale streaming CTC: d256 / 12-block chunked encoder, vocab 4233
# (the offline flagship geometry with chunked attention)
FRONTEND = {
    "input_size": 40, "output_size": 256, "in_channel": 1, "mid_channel": 64,
    "out_channel": 128, "kernel_size": [[3, 3], [3, 3]], "stride": [2, 2],
    "dropout": 0.0, "act_func_type": "relu",
}
ENCODER = {
    "d_model": 256, "n_heads": 4, "d_ff": 2048, "n_blocks": 12,
    "residual_dropout": 0.0, "normalize_before": False, "activation": "glu",
    "relative_positional": False, "chunk_size": 16, "left_chunks": 4,
}
MODEL_CFG = {"type": "ctc", "frontend_type": "conv", "frontend": FRONTEND,
             "encoder_type": "transformer", "encoder": ENCODER,
             "vocab_size": 4233, "lookahead_steps": 0}


def build_server(n_streams: int, device, seed: int = 0) -> MultiStreamCTC:
    torch.manual_seed(seed)
    model = build_model(MODEL_CFG, dtype=torch.bfloat16, device=device)
    return MultiStreamCTC(model, n_streams=n_streams)


def percentiles(xs, ps=(50, 90, 99)) -> dict:
    xs = np.asarray(xs, np.float64) * 1000.0  # ms
    return {f"p{p}": round(float(np.percentile(xs, p)), 1) for p in ps}


def drive(ms: MultiStreamCTC, utts: list, paced: bool) -> tuple[dict, list, float]:
    """All of ``utts`` through the server → (finals by stream, tick host
    seconds, wall seconds)."""
    n = len(utts)
    raw_chunk = ms.raw_chunk
    chunk_audio_s = raw_chunk * 0.01
    finals: dict = {}
    slots = [ms.open_stream(f"s{i}", lambda _t: None,
                            lambda text, _i=i: finals.__setitem__(_i, text))
             for i in range(n)]
    tick_times: list[float] = []
    t_start = time.perf_counter()
    if paced:
        cursors = [0] * n
        next_due = t_start
        while len(finals) < n:
            now = time.perf_counter()
            if now >= next_due:
                # one chunk of audio "arrives" on every open stream
                for i in range(n):
                    if cursors[i] < len(utts[i]):
                        nfr = min(raw_chunk, len(utts[i]) - cursors[i])
                        ms.push(slots[i], utts[i][cursors[i]: cursors[i] + nfr])
                        cursors[i] += nfr
                        if cursors[i] >= len(utts[i]):
                            ms.close(slots[i])
                next_due += chunk_audio_s
            if ms.ready():
                t0 = time.perf_counter()
                ms.tick()
                tick_times.append(time.perf_counter() - t0)
            else:
                time.sleep(0.001)
    else:
        for i in range(n):
            ms.push(slots[i], utts[i])
            ms.close(slots[i])
        while len(finals) < n:
            if ms.ready():
                t0 = time.perf_counter()
                ms.tick()
                tick_times.append(time.perf_counter() - t0)
            else:
                time.sleep(0.001)
    return finals, tick_times, time.perf_counter() - t_start


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-n", "--streams", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="audio seconds per stream (10 ms frames)")
    ap.add_argument("--paced", action="store_true",
                    help="real-time arrival instead of saturated drive")
    ap.add_argument("--seed", type=int, default=0, help="the random weights' seed")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    clock = profiling.clock(device)
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")

    n = args.streams
    t_frames = int(args.seconds * 100)
    ms = build_server(n, device, args.seed)
    raw_chunk = ms.raw_chunk  # feature frames consumed per tick per stream
    chunk_audio_s = raw_chunk * 0.01
    rng = np.random.default_rng(1)
    utts = [rng.normal(size=(t_frames, 40)).astype(np.float32) * 2.0 for _ in range(n)]

    # warm-up: one stream of a window and a chunk, drained (the same row
    # shapes as every later tick)
    slot = ms.open_stream("warm", lambda _t: None, lambda _t: None)
    ms.push(slot, utts[0][: ms.window + raw_chunk])
    ms.close(slot)
    while ms.ready():
        ms.tick()

    ticks0, chunks0, k1_0 = ms.ticks, ms.chunks_advanced, project_logp_topk.launches
    finals, tick_times, wall = drive(ms, utts, args.paced)
    ticks, chunks = ms.ticks - ticks0, ms.chunks_advanced - chunks0
    launches = project_logp_topk.launches - k1_0

    audio_total = n * args.seconds
    mode = "paced" if args.paced else "saturated"
    pct = percentiles(tick_times)
    print(f"mode={mode} streams={n} audio={args.seconds:.0f}s/stream "
          f"chunk={raw_chunk} frames ({chunk_audio_s * 1000:.0f} ms) "
          f"encoder=d{ENCODER['d_model']}x{ENCODER['n_blocks']}L "
          f"chunk_size={ENCODER['chunk_size']} left={ENCODER['left_chunks']}")
    print(f"ticks={ticks} chunks_advanced={chunks} "
          f"(fused batching x{chunks / max(ticks, 1):.1f})")
    print(f"per-tick latency ms ({clock} clock, {len(tick_times)} ticks): {pct} "
          "(one fused step a tick)")
    print(f"wall={wall:.2f}s for {audio_total:.0f}s audio -> per-stream RTF="
          f"{wall / args.seconds / n:.4f} (aggregate {audio_total / wall:.1f}x "
          f"real-time across {n} streams)")
    sustainable = n * chunk_audio_s / float(np.percentile(tick_times, 50))
    print(f"sustainable load at p50 tick: ~{sustainable:.1f} concurrent "
          f"real-time streams per card (linear in the rows from {n} streams; a run "
          "at that many streams measures it)")
    record = {"device": device.type, "clock": clock, "mode": mode, "streams": n,
              "seconds": args.seconds, "chunk_frames": raw_chunk, "ticks": ticks,
              "chunks_advanced": chunks, "tick_ms": pct, "wall_s": wall,
              "rtf_per_stream": wall / args.seconds / n, "aggregate_rt": audio_total / wall,
              "sustainable_streams": sustainable, "finals": len(finals),
              "kernel1_launches": launches}
    if device.type == "cuda":
        record["card"] = profiling.card_line()
        print(record["card"])
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
