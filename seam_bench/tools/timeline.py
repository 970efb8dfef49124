"""A cell's window second by second, for finding where a run's time goes.

    python3 seam_bench/tools/timeline.py --workload catchup.fused128k \
        --seed 7 --seconds 60

Runs the cell as a benchmark run does (set-up, warm-up, closed loop) and
prints, instead of the result line: verdicts completed in each second of
the window, the dispatch walls' percentiles, the longest dispatches, and
the process's page faults and context switches over the window.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from seam_bench import corpus as corpus_mod  # noqa: E402
from seam_bench import harness  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    import torch
    from stellar_core_tpu_torch.native.loader import get_lib
    cell = harness.Cell(harness.load_json(
        os.path.join(harness.ROOT, "BENCHMARK.json")), args.workload)
    seam = harness.load_module("seams", cell.config["seam"]).build("cuda")
    corpus = corpus_mod.build(cell.config, cell.traffic, args.seed, get_lib())
    run = harness.Run(cell, corpus, args.seconds)
    verdicts = harness.Verdicts(corpus, seam)
    cell.loop.warm_up(seam, corpus, cell.traffic, verdicts)
    torch.cuda.synchronize()
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    run.t_open = time.perf_counter()
    run.t_close = run.t_open + args.seconds
    cell.loop.drive(seam, corpus, cell.traffic, verdicts, run.t_close,
                    run=run)
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    seam.close()
    per_s = [0] * (int(args.seconds) + 1)
    for t in run.t_collect:
        if t <= run.t_close:
            per_s[int(t - run.t_open)] += run.rows
    walls = sorted((c - s) * 1e3 for s, c in zip(run.t_call, run.t_collect))
    calls = [(r - s) * 1e3 for s, r in zip(run.t_call, run.t_return)]
    q = statistics.quantiles(walls, n=100)
    print(json.dumps({
        "workload": cell.name, "seed": args.seed,
        "rows_per_s_each_second": per_s[:-1],
        "wall_ms": {"p10": q[9], "p50": q[49], "p90": q[89], "p99": q[98],
                    "max": walls[-1]},
        "call_ms_p50": statistics.median(calls),
        "longest_ms": walls[-5:],
        "wrong": len(verdicts.wrong),
        "minor_faults": r1.ru_minflt - r0.ru_minflt,
        "major_faults": r1.ru_majflt - r0.ru_majflt,
        "voluntary_switches": r1.ru_nvcsw - r0.ru_nvcsw,
        "involuntary_switches": r1.ru_nivcsw - r0.ru_nivcsw,
        "cpu_user_s": r1.ru_utime - r0.ru_utime,
        "cpu_sys_s": r1.ru_stime - r0.ru_stime}), flush=True)


if __name__ == "__main__":
    main()
