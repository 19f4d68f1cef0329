#!/usr/bin/env python3
"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

Run from the root of a checkout, on a machine with the card(s) the cell asks
for:

    python3 portbench/run.py --workload din-train --seed 7 --seconds 20 --trace 0

See ``harness.py`` for what a run does and prints, and ``README.md`` for the
cells, the metrics and how to add either.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
