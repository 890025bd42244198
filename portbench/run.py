#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch and CUDA port once.

    python3 portbench/run.py --workload <config>.<mix> --seed N --seconds S --trace 0|1

Loads, warms up, measures for ``--seconds`` seconds and prints one JSON line
last (see ``portbench/README.md``).
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.core.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_process=T_PROCESS))
