"""Runs one cell of the benchmark of graphcast_tpu_torch once, on the
CUDA device this process sees, and prints its result as the last line of
standard output.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

From the root of a checkout. The cells, configurations, traffic mixes and
metrics are listed in BENCHMARK.json; portbench/harness.py says what a run
does. Exits 2 without a result where CUDA or the cell's devices are
missing.
"""

import pathlib
import sys
import time

T0 = time.perf_counter()

if __name__ == "__main__":
  sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
  from portbench import harness
  harness.set_environment()
  sys.exit(harness.main(sys.argv[1:], T0))
