"""Run one cell of the benchmark once and print its result.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace 0

The cells, their configurations and metrics are in ``BENCHMARK.json`` at
the root of the checkout; ``README.md`` beside this file says what a run
does and prints.
"""
import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

from harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0, BENCH.parent))
