"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

--trace 0 prints the cell's end-to-end metrics, --trace 1 its per-layer
metrics from a profiled window. The last line of standard output is one
JSON object (correct, attempted, failed, metrics, device, [breakdown],
checks); standard error ends with each compared number beside its
limit. Without a CUDA card the run fails and prints no result."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:]))
