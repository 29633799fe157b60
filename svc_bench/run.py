"""Run one cell of BENCHMARK.json once and print its result line:

    python3 svc_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``python3 -m svc_bench.run`` works too). It
needs a CUDA card; without one it exits with code 3 and prints no result.
"""
import time

T_START = time.perf_counter()  # the set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the CUDA driver's kernel cache at a fixed path inside the checkout; the
# port's kernels build into build/kernels there too (ops/kernels.py)
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda_cache"))
os.environ.setdefault("OMP_NUM_THREADS", "1")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from svc_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
