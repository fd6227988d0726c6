"""Run one cell of ``BENCHMARK.json`` once on the CUDA card:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints one JSON line last on standard
output; exits with another code than 0, and prints no result, without a
card, or when the run loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()    # set-up runs from here to the first timed call

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench.core import harness

    sys.exit(harness.main(sys.argv[1:], T0))
