"""The run of one cell: arguments, the chip check, the cell's files found by
name, the traced window, the per-layer readers and the result line.

A cell ``<config>.<mix>`` of ``BENCHMARK.json`` names its configuration
(``portbench/configs/<config>.json``) and its traffic mix
(``portbench/mixes/<mix>.json``). The mix names the driver
(``portbench/drivers/<driver>.py``) that runs it; the per-layer metrics
whose ``workloads`` list the cell are read by ``portbench/metrics/<name>.py``
in the run with ``--trace 1``. Nothing here lists a cell, a mix or a
metric by hand.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field

PB_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
# modules that may not be loaded in the process that prints the result,
# compared by whole top-level name ("opentransformer_tpu_torch" is the port)
FORBIDDEN = ("jax", "jaxlib", "flax", "opentransformer_tpu")
# build and kernel caches of the run, at fixed paths inside the checkout
CACHE_DIR = os.path.join(ROOT, ".portbench_cache")


class BenchError(RuntimeError):
    """A run that cannot give a result: no chip, a missing file, a
    forbidden module."""


def load_json(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A Python file of the benchmark, imported by its path."""
    if not os.path.exists(path):
        raise BenchError(f"{os.path.relpath(path, ROOT)} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of ``workloads`` with its configuration, mix and metrics."""

    name: str
    chips: int
    config: dict
    mix: dict
    per_layer: list = field(default_factory=list)   # the manifest's entries
    end_to_end: list = field(default_factory=list)


def resolve_cell(name: str, manifest: dict | None = None) -> Cell:
    """The cell ``name`` of the manifest, its files read by name."""
    manifest = manifest if manifest is not None else load_json(MANIFEST)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    mix = load_json(os.path.join(PB_DIR, "mixes", w["traffic"] + ".json"))

    def applies(metric):
        return name in metric.get("workloads", [name])

    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                per_layer=[m for m in manifest["per_layer"] if applies(m)],
                end_to_end=[m for m in manifest["end_to_end"] if applies(m)])


def load_driver(cell: Cell):
    """The driver the cell's mix names, ``portbench/drivers/<driver>.py``."""
    name = cell.mix["driver"]
    return load_module(os.path.join(PB_DIR, "drivers", name + ".py"), "pb_driver_" + name)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every build and kernel cache of the run under the checkout, at fixed
    paths (the port builds its kernels in its own ``_build`` there)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_ext"),
                     ("CUDA_CACHE_PATH", "cuda")):
        path = os.path.join(CACHE_DIR, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


@dataclass
class Check:
    """One number compared, with its limit (``value <= limit`` passes)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks_of(readings: dict, limits: dict) -> list:
    """The numbers of ``readings`` that ``limits`` names, each beside its limit."""
    return [Check(k, readings[k], limits[k]) for k in sorted(limits)]


def passes(readings: dict, limits: dict) -> bool:
    """Whether ``readings`` (the program's, a control's or a fault's) pass
    every limit."""
    return all(c.ok for c in checks_of(readings, limits))


@dataclass
class Outcome:
    """What a driver hands back after its window."""

    attempted: int
    failed: int
    metrics: dict            # end-to-end name -> value
    checks: list             # [Check]
    memory_peak_bytes: int
    trace: object = None     # core.trace.TraceData in a traced run
    extra: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) and self.failed == 0


def fmt(x: float) -> float:
    """A number as measured (JSON has no NaN: a non-finite value is None)."""
    return float(x) if math.isfinite(float(x)) else None


def result_line(cell: Cell, out: Outcome, device: dict, per_layer: dict) -> dict:
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    values = per_layer if out.trace is not None else out.metrics
    line = {
        "correct": out.correct,
        "attempted": int(out.attempted),
        "failed": int(out.failed),
        "metrics": {k: {"value": fmt(v), "unit": units[k]} for k, v in values.items()},
        "device": device,
    }
    if out.trace is not None:
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {c.name: {"value": fmt(c.value), "limit": c.limit} for c in out.checks}
    return line


def read_per_layer(cell: Cell, out: Outcome) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing returns None and the metric is left out."""
    values = {}
    for m in cell.per_layer:
        mod = load_module(os.path.join(PB_DIR, "metrics", m["name"] + ".py"),
                          "pb_metric_" + m["name"].replace(".", "_"))
        v = mod.read(out.trace)
        if v is not None:
            values[m["name"]] = float(v)
    return values


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_process: float | None = None) -> int:
    t_process = time.perf_counter() if t_process is None else t_process
    args = parse_args(argv)
    try:
        cell = resolve_cell(args.workload)
        set_cache_dirs()
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise BenchError(f"{cell.name} needs {cell.chips} CUDA device(s); "
                             f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                             f"device_count={torch.cuda.device_count()}")
        driver = load_driver(cell)
        ctx = RunContext(cell=cell, seed=args.seed, seconds=args.seconds,
                         traced=bool(args.trace), device=torch.device("cuda"),
                         t_process=t_process, limits=load_limits(cell.name))
        out = driver.run(ctx)
        per_layer = read_per_layer(cell, out) if args.trace else {}
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": cell.chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
        if out.trace is not None:
            device["busy_s"] = out.trace.busy_s
            device["window_s"] = out.trace.window_s
        line = result_line(cell, out, device, per_layer)
        found = forbidden_modules()  # the last step before the result is printed
        if found:
            raise BenchError(f"forbidden modules loaded in the run: {found}")
    except BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    for c in out.checks:
        print(f"check {c.name} = {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


@dataclass
class RunContext:
    """What a driver gets: the cell, the seed, the window's length, whether
    the run is traced, the device and the process's start on the host clock."""

    cell: Cell
    seed: int
    seconds: float
    traced: bool
    device: object
    t_process: float
    limits: dict = field(default_factory=dict)
    control: bool = False   # also read the control (the calibration runs)


def load_limits(cell: str) -> dict:
    """The limits of the cell's compared numbers, ``portbench/limits/<cell>.json``."""
    return {k: float(v["limit"]) for k, v in
            load_json(os.path.join(PB_DIR, "limits", cell + ".json"))["limits"].items()}
