"""The port's benchmark: one run of one cell, printed as one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration and traffic; see ``benchmark/harness.py``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root in place of this folder, whose module names would
# shadow others
sys.path[0] = ROOT
from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    harness.process_env()
    sys.exit(harness.main(sys.argv[1:], T_START))
