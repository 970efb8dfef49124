"""Run a command and print its peak resident set size.

    python tests/peak_rss.py <command> [arguments]

Runs the command, then prints one line: the largest resident set size
of any of its processes that were waited for (the command itself, and
the worker processes it started and joined), from
getrusage(RUSAGE_CHILDREN).ru_maxrss (KiB on Linux), and the wall.
Exits with the command's exit code.
"""

import resource
import subprocess
import sys
import time


def main(argv):
    t0 = time.perf_counter()
    rc = subprocess.call(argv)
    kib = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    print(f"peak RSS of {' '.join(argv)}: {kib / 1024:.1f} MiB, "
          f"rc {rc}, {time.perf_counter() - t0:.1f} s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
