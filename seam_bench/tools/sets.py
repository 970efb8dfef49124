"""Run cells of the benchmark as separate processes, one after another, and
summarise their spread.

    python3 seam_bench/tools/sets.py --out out/sets.jsonl \
        --cells catchup.fused128k --seeds 101,102,103 \
        --sets 2 --seconds 30 [--trace 1]

Each run is `python3 seam_bench/run.py ...` from the checkout's root, as
a benchmark run is started; each line of --out is one run: cell, set,
seed, exit code, wall, the result line and the tail of standard error.
The summary gives, per cell, metric and set, the median and the spread:
the distance between the first and third quartiles
(statistics.quantiles, n=4) over the median, with the run farthest from
the median left out where that narrows it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spread(values):
    """(median, spread) with the run farthest from the median left out
    where that narrows the spread."""
    def one(v):
        med = statistics.median(v)
        q = statistics.quantiles(v, n=4)
        return med, (q[2] - q[0]) / med
    med, s = one(values)
    if len(values) >= 5:
        far = max(values, key=lambda x: abs(x - med))
        rest = list(values)
        rest.remove(far)
        s = min(s, one(rest)[1])
    return med, s


def summarise(lines):
    groups = {}
    for r in lines:
        line = r.get("line") or {}
        for name, m in (line.get("metrics") or {}).items():
            groups.setdefault((r["cell"], r["set"], name), []).append(
                m["value"])
    for key in sorted(groups):
        v = groups[key]
        if len(v) >= 3:
            med, s = spread(v)
            print(f"{key}: n {len(v)} median {med:.6g} spread {s:.4f} "
                  f"min {min(v):.6g} max {max(v):.6g}", flush=True)
        else:
            print(f"{key}: {v}", flush=True)


def one_run(args, s, cell, seed):
    """One run in a process of its own; its record, also appended to
    --out."""
    cmd = [sys.executable, "seam_bench/run.py", "--workload", cell,
           "--seed", seed, "--seconds", str(args.seconds),
           "--trace", str(args.trace)]
    t = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=args.timeout)
        rc, stdout, stderr = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, stdout, stderr = "timeout", e.stdout or "", e.stderr or ""
        stdout = stdout if isinstance(stdout, str) else stdout.decode()
        stderr = stderr if isinstance(stderr, str) else stderr.decode()
    wall = time.perf_counter() - t
    out = stdout.strip().splitlines()
    try:
        line = json.loads(out[-1]) if out else None
    except json.JSONDecodeError:
        line = None
    rec = {"cell": cell, "set": s, "seed": int(seed), "trace": args.trace,
           "rc": rc, "wall_s": wall, "line": line,
           "stderr_tail": stderr[-1500:]}
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    short = {k: round(v["value"], 4)
             for k, v in ((line or {}).get("metrics") or {}).items()}
    print(f"{cell} set {s} seed {seed} rc {rc} wall {wall:.1f} correct "
          f"{(line or {}).get('correct')} {short}", flush=True)
    if rc or line is None:
        print(stderr[-3000:], flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=1200)
    args = ap.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    lines = [one_run(args, s, cell, seed)
             for s in range(1, args.sets + 1)
             for seed in args.seeds.split(",")
             for cell in args.cells.split(",")]
    summarise(lines)


if __name__ == "__main__":
    main()
