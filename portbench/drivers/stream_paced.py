"""Live captioning: an open loop of ``streams`` concurrent sessions through
``MultiStreamCTC.open_stream`` / ``push`` / ``tick`` / ``close``, as
``cli/serve.py --streaming`` serves them (one slot a session).

Each session plays utterances back to back; a client sends a chunk of
``chunk_ms`` of features when its last frame is due, at its own phase
(the phases spread evenly over a chunk, dealt to the sessions by the seed),
so arrivals are staggered and the loop is open: a late tick delays what is
due, it does not slow the clients. One host thread pushes every chunk that
is due, then runs a tick whenever a chunk is pending. The window covers
the chunks due in ``--seconds``; the run goes on until they are out (at
most ``drain_s`` more), and a chunk not out by then counts in ``failed``.
``stream_p95_ms`` is the 95th percentile over the window's chunks of the
time from when a chunk's last frame was due to the end of the tick that
consumed it (its PARTIAL is out then). The front end consumes a chunk once
the first frames of the next have arrived, or the stream is closed.

``correct``: once the window has closed, the utterances that the sessions
drawn from the seed finished (their FINAL out) are encoded offline by the
plain reference (``reference/conformer_ctc.py``) under the chunk mask, in
float32: ``ctc_id_gap`` is the widest margin by which a served frame id's
reference log-prob lies below the frame's best, ``memory_rel_err`` the
widest gap of the streamed memory over the reference's largest value, and
``frames_missing`` the frames of those utterances with no served id.
"""

from __future__ import annotations

import heapq
import time

import numpy as np
import torch

from portbench.core import counts, traffic
from portbench.core.harness import Outcome, checks_of
from portbench.core.trace import Tracer
from portbench.core.weights import load_into, make_weights, param_shapes, subseed
from portbench.reference import conformer_ctc as ref
from portbench.reference.precision import BELOW, FP32, no_tf32

BANK_FRAMES = 1 << 18  # the seeded feature bank utterances are cut from


class Session:
    """One client: its utterances, the one it plays, its next chunk, its slot."""

    __slots__ = ("utts", "u", "chunk", "slot", "start")

    def __init__(self, utts):
        self.utts, self.u, self.chunk, self.slot, self.start = utts, 0, 0, None, 0.0


def plan(mix: dict, seed: int, n: int):
    """Per session its utterances [(frames, bank offset)] and its phase (s):
    the same sizes and phases for every seed, dealt by the seed."""
    per = int(mix["utterances_per_session"])
    utts = [f for f, _ in traffic.utterances(dict(mix, utterances=n * per))]
    rng = np.random.Generator(np.random.PCG64(subseed(seed, "sessions")))
    deal = rng.permutation(len(utts))
    offsets = rng.integers(0, BANK_FRAMES - max(utts), size=len(utts))
    phases = (np.arange(n) + 0.5) / n * mix["chunk_ms"] / 1000.0
    phases = phases[rng.permutation(n)]
    return [[(utts[deal[i * per + j]], int(offsets[i * per + j])) for j in range(per)]
            for i in range(n)], phases.tolist()


def run(ctx, tick=None) -> Outcome:
    """One run of the cell; ``tick(ms)`` replaces the call into the port
    (the fault tests break the path with it)."""
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk
    from opentransformer_tpu_torch.recognize.multistream import MultiStreamCTC

    mix, cfg = ctx.cell.mix, ctx.cell.config
    model_cfg = cfg["model"]
    dev = ctx.device
    tracer = Tracer(dev, ctx.traced)
    tick = tick or (lambda ms: ms.tick())
    n = int(mix["streams"])
    chunk_s = mix["chunk_ms"] / 1000.0
    frame_s = mix["frame_shift_ms"] / 1000.0

    model = build_model(model_cfg, dtype=getattr(torch, cfg["precision"]), device=dev)
    weights = make_weights(param_shapes(model), ctx.seed, dev, model.dtype)
    load_into(model, weights)
    n_mel = model_cfg["frontend"]["input_size"]
    gen = torch.Generator(device=dev).manual_seed(subseed(ctx.seed, "bank"))
    bank = torch.randn((BANK_FRAMES, n_mel), generator=gen, device=dev).cpu().numpy()
    utts, phases = plan(mix, ctx.seed, n)
    ms = MultiStreamCTC(model, n_streams=n)
    raw_chunk = ms.raw_chunk
    if abs(raw_chunk * frame_s - chunk_s) > 1e-9:
        raise ValueError(f"chunk_ms {mix['chunk_ms']} is not the model's chunk of "
                         f"{raw_chunk} frames")

    # the served ids and memory of the sampled sessions, by (session, utterance)
    rng = np.random.Generator(np.random.PCG64(subseed(ctx.seed, "sample")))
    sampled = set(rng.choice(n, size=min(n, int(mix["check_sessions"])), replace=False).tolist())
    sampled.add(max(range(n), key=lambda i: max(f for f, _ in utts[i][:3])))
    owner: dict = {}     # slot -> (session, utterance)
    served: dict = {}    # (session, utterance) -> {encoder frame: (id, memory row)}
    encode, advance_rows = ms._encode, ms._advance_rows
    last_y = {}

    def encode_kept(*args):
        y = encode(*args)
        last_y["y"] = y
        return y

    def advance_kept(window, start, cache_len, chunk_mask, advance, fresh, fin_now):
        ids = advance_rows(window, start, cache_len, chunk_mask, advance, fresh, fin_now)
        rows = [int(r) for r in np.flatnonzero(advance)
                if owner.get(int(r), (None,))[0] in sampled]
        if rows:
            ys = last_y["y"][rows].detach().cpu()
            for y, row in zip(ys, rows):
                got = served.setdefault(owner[row], {})
                for t in range(int(chunk_mask[row].sum())):
                    got[int(start[row]) + t] = (int(ids[row, t]), y[t])
        consumed.append((advance.copy(), start.copy()))
        return ids

    ms._encode, ms._advance_rows = encode_kept, advance_kept

    # warm-up: every slot through a few chunks, then all closed and drained
    consumed: list = []
    for i in range(n):
        ms.open_stream(f"w{i}", lambda text: None, lambda text: None)
    for _ in range(3):
        for i in range(n):
            ms.push(i, bank[i * 7: i * 7 + raw_chunk])
        while ms.ready():
            tick(ms)
    for i in range(n):
        ms.close(i)
    while ms.ready():
        tick(ms)
    tracer.sync()
    if ms.free_slots() != n:
        raise RuntimeError("the warm-up left slots busy")
    consumed.clear()
    setup_s = time.perf_counter() - ctx.t_process

    sessions = [Session(u) for u in utts]
    finals: dict = {}
    due_of: dict = {}     # (session, utterance, chunk) -> due time
    done_at: dict = {}    # (session, utterance, chunk) -> time out
    late: list = []
    heap = []
    launches0 = project_logp_topk.launches
    ticks_before = ms.ticks
    with tracer.window():
        t0 = time.perf_counter() + 0.05
        t_end = t0 + ctx.seconds
        for i, s in enumerate(sessions):
            s.start = t0 + phases[i] - chunk_s   # so that chunk 0 is due at t0 + phase
            heapq.heappush(heap, (t0 + phases[i], i))
        while True:
            now = time.perf_counter()
            while heap and heap[0][0] <= now:
                due, i = heapq.heappop(heap)
                s = sessions[i]
                if s.slot is None:
                    slot = ms.open_stream(f"{i}.{s.u}", lambda text: None,
                                          lambda text, key=(i, s.u): finals.setdefault(
                                              key, time.perf_counter()), timeout=0)
                    if slot is None:  # every slot busy: try again at once
                        heapq.heappush(heap, (now + 1e-3, i))
                        continue
                    s.slot = slot
                    owner[slot] = (i, s.u)
                frames, off = s.utts[s.u % len(s.utts)]
                lo = s.chunk * raw_chunk
                hi = min(frames, lo + raw_chunk)
                ms.push(s.slot, bank[off + lo: off + hi])
                t_due = s.start + (s.chunk + 1) * chunk_s if hi - lo == raw_chunk else \
                    s.start + s.chunk * chunk_s + (hi - lo) * frame_s
                late.append(time.perf_counter() - t_due)
                if t_due <= t_end:
                    due_of[(i, s.u, s.chunk)] = t_due
                s.chunk += 1
                if hi >= frames:  # the utterance's last chunk: close, next one follows
                    ms.close(s.slot)
                    s.slot, s.chunk, s.u = None, 0, s.u + 1
                    s.start = t_due
                    nxt = t_due + chunk_s
                else:
                    nxt = s.start + (s.chunk + 1) * chunk_s
                    nxt = min(nxt, s.start + frames * frame_s) if (s.chunk + 1) * raw_chunk \
                        > frames else nxt
                if nxt <= t_end + chunk_s:
                    heapq.heappush(heap, (nxt, i))
            if ms.ready():
                mark = len(consumed)
                owners = dict(owner)
                with tracer.span("recognize.tick"):
                    tick(ms)
                t_out = time.perf_counter()
                for adv, start in consumed[mark:]:
                    for row in np.flatnonzero(adv):
                        key = owners.get(int(row))
                        if key is not None:
                            done_at.setdefault((*key, int(start[row]) // ms.chunk), t_out)
                continue
            if not heap and now > t_end:
                break
            if now > t_end + float(mix["drain_s"]):
                break
            if heap:
                time.sleep(max(0.0, min(heap[0][0] - time.perf_counter(), 2e-3)))
    window_s = tracer.window_s
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    out_at = {}   # a raw chunk is out with the encoder chunk that holds its last frames
    for (i, u, c), t in due_of.items():
        frames = utts[i][u % len(utts[i])][0]
        last = -(-model.frontend.output_length(frames) // ms.chunk) - 1
        if (i, u, min(c, last)) in done_at:
            out_at[(i, u, c)] = done_at[(i, u, min(c, last))]
    lat = sorted(out_at[k] - t for k, t in due_of.items() if k in out_at)
    failed = len(due_of) - len(out_at)
    p95 = pct95(lat) * 1e3
    first = pct95(sorted(out_at[k] - t for k, t in due_of.items()
                         if k in out_at and t < t0 + ctx.seconds / 2)) * 1e3
    last = pct95(sorted(out_at[k] - t for k, t in due_of.items()
                        if k in out_at and t > t_end - 2.0)) * 1e3
    ticks = ms.ticks - ticks_before
    enc = model_cfg["encoder"]
    fe = model_cfg["frontend"]
    rows = [int(adv.sum()) for adv, _ in consumed]
    f_front, _ = counts.conv_frontend(ms.window, fe["input_size"], fe["mid_channel"],
                                      fe["out_channel"], fe["output_size"])
    tracer.add_work("flops", sum(r * f_front + counts.conformer_chunk(
        r, ms.chunk, ms.left, enc["d_model"], enc["d_ff"], enc["nblocks"],
        enc["cov_kernel_size"], model_cfg["vocab_size"]) for r in rows))
    tracer.add_work("flops_peak", counts.PEAK_FLOPS[cfg["precision"]])
    tracer.add_work("topk_bound_s", ticks * counts.topk_bound(
        n * ms.chunk, enc["d_model"], model_cfg["vocab_size"], 1, cfg["precision"]))
    tracer.count("kernel1.launches", project_logp_topk.launches - launches0)
    late.sort()
    tracer.count("loadgen.late_p95_s", late[int(0.95 * (len(late) - 1))] if late else 0.0)

    del ms, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    done = sorted(k for k in served if k in finals)
    readings = check(weights, model_cfg, utts, bank, served, done, FP32)
    checks = checks_of(readings, ctx.limits)
    out = Outcome(attempted=len(due_of), failed=failed,
                  metrics={"stream_p95_ms": p95, "setup_s": setup_s},
                  checks=checks, memory_peak_bytes=peak, trace=tracer.data,
                  extra={"readings": readings, "chunks": len(due_of), "ticks": ticks,
                         "window_s": window_s, "p95_first_half_ms": first,
                         "p95_last_2s_ms": last,
                         "tick_ms": 1e3 * tracer.spans_total("recognize.tick") / max(ticks, 1)})
    if getattr(ctx, "control", False):
        out.extra["control"] = check(weights, model_cfg, utts, bank, served, done,
                                     BELOW[cfg["precision"]])
    return out


def pct95(sorted_values: list) -> float:
    """The 95th percentile (nearest rank) of sorted values; inf when none."""
    if not sorted_values:
        return float("inf")
    return sorted_values[min(len(sorted_values) - 1, int(0.95 * len(sorted_values)))]


@torch.no_grad()
def check(weights, model_cfg, utts, bank, served, done, prec) -> dict:
    """The readings over the finished utterances of the sampled sessions;
    with ``prec`` another precision's, the reference in the port's place
    (its own frame ids and memory are the ones judged)."""
    no_tf32()
    dev = next(iter(weights.values())).device
    gap, mem_err, missing, frames_checked = 0.0, 0.0, 0, 0
    for i, u in done:
        frames, off = utts[i][u % len(utts[i])]
        x = torch.from_numpy(bank[off: off + frames]).to(dev)[None]
        mask = torch.ones((1, frames), dtype=torch.bool, device=dev)
        memory, mmask = ref.encode(weights, model_cfg, x, mask, FP32)
        logp = torch.log_softmax(ref.linear(weights, "ctc.output_layer", memory), -1)[0]
        got = served[(i, u)]
        t = int(mmask.sum())
        missing += sum(1 for f in range(t) if f not in got)
        have = [f for f in range(t) if f in got]
        if not have:
            continue
        if prec is FP32:
            ids = torch.tensor([got[f][0] for f in have], device=dev)
            ys = torch.stack([got[f][1] for f in have]).to(dev).float()
        else:
            mem_c, _ = ref.encode(weights, model_cfg, x, mask, prec)
            lp_c = torch.log_softmax(ref.linear(weights, "ctc.output_layer", mem_c, prec), -1)[0]
            ids = lp_c[have].argmax(-1)
            ys = mem_c[0, have]
        rows = logp[have]
        gap = max(gap, float((rows.max(-1).values - rows.gather(-1, ids[:, None])[:, 0]).max()))
        want = memory[0, have]
        mem_err = max(mem_err, float((ys - want).abs().max() / want.abs().max()))
        frames_checked += len(have)
    if frames_checked == 0:
        return {"frames_missing": missing, "ctc_id_gap": float("inf"),
                "memory_rel_err": float("inf"), "utterances": 0}
    return {"frames_missing": missing, "ctc_id_gap": gap, "memory_rel_err": mem_err,
            "utterances": len(done), "frames": frames_checked}
