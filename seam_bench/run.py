"""Run one cell of BENCHMARK.json on the card this process sees.

    python3 seam_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints the result as the last line of
standard output, and the numbers compared with their limits as the last
lines of standard error (see harness.py).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from seam_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
