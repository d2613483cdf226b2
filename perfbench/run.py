"""Run one cell of the benchmark once, on the card:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic and
its metrics are found by name in ``BENCHMARK.json``. Prints progress and
the numbers compared against their limits on standard error, and one JSON
result line last on standard output; exits non-zero, with no result, where
the machine shows fewer CUDA cards than the cell needs.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench.harness.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
