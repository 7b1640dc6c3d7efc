"""Run one cell of the benchmark once, on the machine it is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: BENCHMARK.json names the cells. The last line
of standard output is one JSON object (correct, attempted, failed,
metrics, device, with --trace 1 breakdown, and last the numbers compared
with their limits); the numbers compared are also the last lines of
standard error. Without the CUDA devices the cell asks for, the exit code
is not 0 and no result is printed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root in place of this script's folder
sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    sys.exit(harness.main(parse(), T_START))
