#!/usr/bin/env python3
"""Readings that a cell's limits are set from, on the chip, in one process.

    python3 portbench/calibrate.py --workload CELL --seeds 1,2,... [--control-seeds 1,2,3]
        [--seconds 1] [--out FILE]

For each seed a short run of the cell (at least one whole round of its
traffic, at the cell's sizes) prints the program's compared numbers; for
each control seed the control's too, the plain reference put in the port's
place one precision below the configuration's (``reference/precision.py``),
and the readings of the faults that the cell's driver plants in the
reference. Each side is judged by the cell's limits, as the harness judges
a run: ``correct`` is the program's, ``<side>_correct`` the control's and
each fault's, which have to be false, with ``<side>_failed`` the numbers
over their limits. One JSON line a seed; the limits file of a cell
(``portbench/limits/<cell>.json``) records the readings and the limits set
from them. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.core import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    harness.set_cache_dirs()
    cell = harness.resolve_cell(args.workload)
    driver = harness.load_driver(cell)
    limits = harness.load_limits(cell.name)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    seeds += sorted(control - set(seeds))
    lines = []
    for seed in seeds:
        ctx = harness.RunContext(cell=cell, seed=seed, seconds=args.seconds, traced=False,
                                 device=torch.device("cuda"), t_process=time.perf_counter(),
                                 limits=limits, control=seed in control)
        out = driver.run(ctx)
        line = {"seed": seed, "correct": out.correct, "program": out.extra["readings"],
                **{k: v for k, v in out.extra.items() if k != "readings"},
                "metrics": out.metrics}
        for side in sides(out.extra, limits):
            line[side + "_correct"] = harness.passes(out.extra[side], limits)
            line[side + "_failed"] = [c.name for c in harness.checks_of(out.extra[side], limits)
                                      if not c.ok]
        lines.append(line)
        print(json.dumps(line), flush=True)
        del out
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


def sides(extra: dict, limits: dict) -> list:
    """The control's and the faults' readings among a run's extras."""
    return [k for k, v in extra.items() if k != "readings" and isinstance(v, dict)
            and set(limits) <= set(v)]


if __name__ == "__main__":
    sys.exit(main())
