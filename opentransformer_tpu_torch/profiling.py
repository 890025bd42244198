"""Timing and trace reading for the port's measuring tools
(``tools/torch_profile_decode.py``, ``torch_profile_train.py``,
``torch_stream_latency.py``, ``torch_probe_decode_precision.py`` and
``torch_probe_cost_analysis.py``).

``flagship_bench()`` reads the tools' model, ``conf/flagship_bench.json``
(the flagship geometry and its training section). ``Window`` times a block
on the host clock, ending in a device synchronise, and on the card traces
it with ``torch.profiler`` (CUDA activity only, which keeps the host's
share of the trace small): ``device_ms`` is the summed duration of the
kernels, copies and memsets, ``busy_ms`` the union of their intervals, and
``idle_share`` the part of the host window the device spent idle. On the
CPU there is no device, and a window reports its host time alone.
``summarize_trace`` reads a chrome trace written by ``torch.profiler``
(the card's) into the categories of ``CATEGORIES``. The times a tool
prints carry the clock they were taken on: ``device`` for the card's
profiler, ``host`` for the host clock of a card run, ``cpu`` for a CPU run.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

from .config import CONF_DIR

FLAGSHIP_BENCH = os.path.join(CONF_DIR, "flagship_bench.json")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the port's hand-written kernels, by the __global__ names of csrc/*.cu
PORT_KERNELS = (("kernel1 project_logp_topk", ("partial_topk_kernel", "merge_topk_kernel")),
                ("kernel2 project2_logp_topk", ("partial_topk2_kernel", "merge_topk2_kernel")),
                ("kernel3 fbank_spec_mel", ("spec_mel_fft_kernel",)))
# name fragments (lower case) of each category, tried in order
CATEGORIES = (
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "cublas", "cudnn", "conv2d",
              "convolution", "implicit", "wgrad", "dgrad", "aten::mm", "aten::addmm",
              "aten::bmm", "aten::baddbmm", "aten::matmul", "aten::linear", "mkldnn")),
    ("reduction", ("reduce", "softmax", "norm", "sum", "mean", "aten::max", "aten::min",
                   "argmax", "topk", "sort", "logsumexp")),
    ("copy/memset", ("memcpy", "memset", "copy", "fill", "catarray", "aten::cat",
                     "gather", "scatter", "index", "aten::to", "aten::clone",
                     "aten::contiguous", "aten::zero", "aten::empty")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "multi_tensor", "aten::")),
)


def flagship_bench(path: str = FLAGSHIP_BENCH) -> tuple[dict, dict]:
    """(model config, train config) of ``conf/flagship_bench.json`` (or of
    another JSON with those two sections)."""
    with open(path, "r", encoding="utf-8") as f:
        cfg = json.load(f)
    return cfg["model"], cfg["train"]


def category(name: str) -> str:
    """The category of a kernel (or CPU op) name."""
    for cat, names in PORT_KERNELS:
        if any(n in name for n in names):
            return cat
    low = name.lower()
    for cat, frags in CATEGORIES:
        if any(f in low for f in frags):
            return cat
    return "other"


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def clock(device: torch.device) -> str:
    """The label of a host time taken on ``device``'s run."""
    return "host" if device.type == "cuda" else "cpu"


def device_events(trace: dict) -> list[dict]:
    """The device's kernels, copies and memsets of a chrome trace."""
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def busy_us(events: list[dict]) -> float:
    """The union of the events' [ts, ts + dur) intervals, in µs."""
    total, end = 0.0, None
    for e in sorted(events, key=lambda e: e["ts"]):
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if end is None or a >= end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Window:
    """``with Window(device) as w: ...`` — the block's host seconds
    (``w.seconds``, ending in a synchronise) and, on the card, its
    ``torch.profiler`` device time (``w.device_ms``, ``w.busy_ms``,
    ``w.idle_share``, ``w.trace`` the chrome trace, saved to ``keep`` if
    given). ``profile=False`` times the host clock alone."""

    def __init__(self, device: torch.device, profile: bool = True, keep: str | None = None):
        self.device = device
        self.profile = profile and device.type == "cuda"
        self.keep = keep
        self.seconds = 0.0
        self.device_ms = self.busy_ms = self.idle_share = None
        self.trace: dict | None = None
        self._prof = None

    def __enter__(self):
        synchronize(self.device)
        if self.profile:
            self._prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        synchronize(self.device)
        self.seconds = time.perf_counter() - self._t0
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        path = self.keep
        with tempfile.TemporaryDirectory() as tmp:
            if path is None:
                path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path, "r", encoding="utf-8") as f:
                self.trace = json.load(f)
        events = device_events(self.trace)
        if not events:
            raise RuntimeError("the torch.profiler trace of the window holds no device "
                               "event: no device time to report")
        self.device_ms = sum(float(e["dur"]) for e in events) / 1e3
        self.busy_ms = busy_us(events) / 1e3
        self.idle_share = max(0.0, 1.0 - self.busy_ms / (self.seconds * 1e3))
        return False


def summarize_trace(trace: dict, top: int = 30) -> dict:
    """A card's chrome trace → {device_ms, busy_ms, span_ms, idle_share,
    by_category {name: ms}, top [(name, ms, launches)]}. The span runs from
    the first device event's start to the last one's end; the idle share is
    the part of it with no device event running."""
    events = device_events(trace)
    if not events:
        raise RuntimeError("the trace holds no device event (kernel, memcpy or memset): no "
                           "device time to report")
    by_name: dict[str, list] = {}
    for e in events:
        rec = by_name.setdefault(e["name"], [0.0, 0])
        rec[0] += float(e["dur"])
        rec[1] += 1
    by_cat: dict[str, float] = {}
    for name, (us, _) in by_name.items():
        cat = category(name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy = busy_us(events)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"device_ms": sum(us for us, _ in by_name.values()) / 1e3,
            "busy_ms": busy / 1e3, "span_ms": (end - start) / 1e3,
            "idle_share": max(0.0, 1.0 - busy / max(end - start, 1e-9)),
            "by_category": {k: v / 1e3 for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1])},
            "top": [(name, us / 1e3, n) for name, (us, n) in ranked[:top]]}


def summarize_cpu(prof, top: int = 30) -> dict:
    """A CPU run's ``torch.profiler`` → {cpu_self_ms, by_category, top}: the
    operators' self times on the CPU (no device in the run)."""
    rows = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_cpu_time_total > 0]
    by_cat: dict[str, float] = {}
    for name, ms, _ in rows:
        cat = category(name)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
    rows.sort(key=lambda r: -r[1])
    return {"cpu_self_ms": sum(r[1] for r in rows),
            "by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
            "top": rows[:top]}


def card_line() -> str:
    """``name, power limit`` of the card as ``nvidia-smi`` gives them."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "nvidia-smi not available"
