#!/usr/bin/env python3
"""Find the highest load a serving cell keeps up with, once, on the chip.

    python3 portbench/sweep.py --workload CELL --streams 1024,2048,... --seconds 20

Runs the cell's driver at each stream count (the mix's ``streams``
replaced) and prints one JSON line a count: the 95th percentile latency of
the window's chunks, of those due in its first half and in its last two
seconds, the chunks failed, the ticks, the window's wall time and the run's
readings. A count keeps real time when nothing fails, the chunks due in the
window are all out within two seconds of its end (``window_s``), and the
last two seconds' tail is no higher than the first half's: the backlog does
not grow. The cell's fixed
``streams`` is four fifths of the highest such count. Counts run one after
another in one process, so run the highest alone if memory runs short.
"""

from __future__ import annotations

import argparse
import copy
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
    ap.add_argument("--streams", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 1)
    args = ap.parse_args(argv)
    import torch

    harness.set_cache_dirs()
    cell = harness.resolve_cell(args.workload)
    driver = harness.load_driver(cell)
    for n in (int(s) for s in args.streams.split(",")):
        c = copy.deepcopy(cell)
        c.mix["streams"] = n
        ctx = harness.RunContext(cell=c, seed=args.seed, seconds=args.seconds, traced=False,
                                 device=torch.device("cuda"), t_process=time.perf_counter(),
                                 limits=harness.load_limits(cell.name))
        out = driver.run(ctx)
        print(json.dumps({"streams": n, "failed": out.failed, "attempted": out.attempted,
                          **out.metrics, **{k: v for k, v in out.extra.items()
                                            if k != "readings"},
                          "readings": out.extra["readings"]}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
