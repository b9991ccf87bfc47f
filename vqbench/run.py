"""Runs one cell of the port's benchmark (``BENCHMARK.json``) on the card:

    python3 vqbench/run.py --workload sift1m.sync_delta --seed 7 \
        --seconds 20 --trace 0

from the root of a checkout.  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``checks``: each number compared
beside its limit, which also close standard error).  It exits 2 without a
CUDA device, and fails without printing a result where the program
(``src/repro_torch``) is missing or JAX got loaded.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vqbench import harness  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(harness.main(t_start=T_START))
