"""The benchmark of elf_tpu_torch on one NVIDIA H100: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The cell, its configuration, traffic,
limits and metrics are found by name from BENCHMARK.json (see
harness/core.py).  Prints the check of each compared number beside its
limit on stderr, then one JSON line on stdout: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
ones), device, with --trace 1 breakdown, and checks.  Exits 2 without a
result when no card is there.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(t_start=T_START))
