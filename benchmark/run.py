"""One run of one benchmark cell (see `benchmark/harness.py`):

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# keep the libraries the port uses from loading JAX or flax themselves
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(T0))
