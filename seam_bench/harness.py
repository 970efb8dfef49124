"""One run of one cell of BENCHMARK.json: set-up, the measured window, the
check of every verdict, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name:

- the cell's configuration: the `file` that BENCHMARK.json gives it; its
  `seam` names `seams/<seam>.py` (the system under test) and its
  `reference` names `reference/<reference>.py` (the plain verifier);
- the cell's traffic: `traffic/<traffic>.json` (its rows per dispatch,
  worked out by `sizing.py`, its distinct batches, and the parameters
  of its loop), whose `loop` names `loops/<loop>.py`, which runs the
  window (`warm_up` and `drive`);
- each metric the cell reports: `metrics/<name>.py`, whose
  `read(run)` returns the number or None (nothing to read: the metric is
  left out of the line).

A run: build the seam (the kernels load, the card wakes), make the rows
from the seed (`corpus.py`), warm up with every batch in the cell's own
pattern, then drive the traffic for `seconds` by the cell's loop.
`setup_s` is the process's age when the window opens. With
`trace` the window runs under `torch.profiler` with host spans (see
trace.py) and the line carries the per-layer metrics; without, the
end-to-end ones.

The check, once the window has closed (`check`): every verdict of every
dispatch, warm-up and late ones included, against the row's label; the
plain reference on a sample of the rows drawn from the seed, against
the labels and against every verdict the program gave those rows; and
the supervisor's failures and skips, each of which the host's verifier
served in the card's place.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "stellar_core_tpu")
REFERENCE_ROWS = 256


class BenchError(RuntimeError):
    """A run that must print no result."""


def process_age() -> float:
    """Seconds since this process started (interpreter start included)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """seam_bench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise BenchError(f"no {kind} file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"seam_bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(entry, cell) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


class Cell:
    """A workload of BENCHMARK.json with its files read."""

    def __init__(self, bench: dict, name: str):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise BenchError(f"no workload {name!r} in BENCHMARK.json")
        w = by_name[name]
        self.name, self.chips = name, int(w["chips"])
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        self.config = load_json(os.path.join(ROOT, conf["file"]))
        self.config["name"] = conf["name"]
        from . import sizing
        traffic = load_json(
            os.path.join(HERE, "traffic", w["traffic"] + ".json"))
        self.traffic = dict(traffic, rows_per_dispatch=sizing.
                            rows_per_dispatch(self.config, traffic))
        self.loop = load_module("loops", traffic["loop"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _reports(m, name)]
        self.per_layer = [m for m in bench["per_layer"]
                          if _reports(m, name)]


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self, cell, corpus, seconds):
        self.cell = cell
        self.corpus = corpus
        self.seconds = seconds
        self.rows = len(corpus.batches[0])
        self.setup_s = None
        self.t_open = self.t_close = None
        # per dispatch of the window (late ones included): batch index,
        # host clock at the call, at its return and at the collect's
        self.batch, self.t_call, self.t_return, self.t_collect = \
            [], [], [], []
        self.trace = None            # trace.Trace of a traced run
        self.imad_per_s = None       # the card's rate, traced runs only
        self._ladder = {}

    def in_window(self):
        """Indices of the dispatches whose verdicts came back in the
        window."""
        return [i for i, t in enumerate(self.t_collect) if t <= self.t_close]

    def ladder_products(self, b: int) -> int:
        """The ladder's products on batch b, counted once per batch."""
        if b not in self._ladder:
            from . import bounds
            self._ladder[b] = bounds.ladder_products(self.corpus.batches[b])
        return self._ladder[b]


class Verdicts:
    """Every verdict list that differs from its batch's labels, and the
    rows the host's verifier served."""

    def __init__(self, corpus, seam):
        self.labels = corpus.labels
        self.seam = seam
        self.health = seam.health()
        self.dispatches = [0] * len(corpus.batches)
        self.wrong = []              # (batch, verdict list)
        self.fallback_rows = 0

    def take(self, b, v):
        self.dispatches[b] += 1
        if v != self.labels[b]:
            self.wrong.append((b, v))
        h = self.seam.health()
        if h != self.health:
            self.health = h
            self.fallback_rows += len(self.labels[b])


def check(run, verdicts, reference, seed):
    """({name: (value, limit)} of the comparison with the labels and the
    plain reference, the count of wrong verdicts, the rows the reference
    checked)."""
    import numpy as np
    from . import corpus as corpus_mod
    corpus = run.corpus
    wrong_rows = 0
    # per batch, per row: how many of its verdicts differ from its label
    off = {}
    for b, v in verdicts.wrong:
        lab = np.asarray(verdicts.labels[b], dtype=bool)
        got = np.asarray(v, dtype=bool) if len(v) == len(lab) \
            else ~lab
        diff = got != lab
        wrong_rows += int(diff.sum())
        off[b] = off.get(b, 0) + diff.astype(np.int64)
    # the reference's sample: half from the broken rows, the rest from
    # the others, over the batches dispatched
    gen = corpus_mod.rng(seed, "reference." + run.cell.name)
    used = [b for b, n in enumerate(verdicts.dispatches) if n]
    rows = [(b, j) for b in used for j in range(len(corpus.labels[b]))]
    bad = [r for r in rows if corpus.kinds[r[0]][r[1]] >= 0]
    good = [r for r in rows if corpus.kinds[r[0]][r[1]] < 0]
    want = int(run.cell.config.get("reference_rows", REFERENCE_ROWS))
    n_bad = min(len(bad), want // 2)
    n_good = min(len(good), want - n_bad)
    sample = [bad[i] for i in gen.choice(len(bad), n_bad, replace=False)] \
        + [good[i] for i in gen.choice(len(good), n_good, replace=False)]
    label_errors = reference_mismatch = 0
    for b, j in sample:
        ref = bool(reference.verify(*corpus.batches[b][j]))
        label = corpus.labels[b][j]
        label_errors += ref != label
        n_off = int(off[b][j]) if b in off else 0
        # the program gave this row `label` in all but n_off of its
        # dispatches of batch b, and `not label` in n_off
        if ref == label:
            reference_mismatch += n_off > 0
        else:
            reference_mismatch += n_off < verdicts.dispatches[b]
    checks = {
        "verdict_mismatch": (wrong_rows, 0),
        "reference_mismatch": (reference_mismatch, 0),
        "label_errors": (label_errors, 0),
        "host_fallback_rows": (verdicts.fallback_rows, 0),
    }
    return checks, wrong_rows, len(sample)


def _forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", log=None):
    """One run; returns (result dict, check lines). `device` "cpu" runs
    the program's plain versions (the tests)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    # the interpreter's start and the imports of the harness and torch
    parts = {"start": process_age()}
    t = time.perf_counter()
    import torch
    from . import corpus as corpus_mod
    seam_mod = load_module("seams", cell.config["seam"])
    reference = load_module("reference", cell.config["reference"])
    readers = {m["name"]: load_module("metrics", m["name"])
               for m in (cell.per_layer if trace else cell.end_to_end)}
    parts["imports"] = time.perf_counter() - t

    t = time.perf_counter()
    on_card = device == "cuda"
    if on_card:
        torch.cuda.init()
        torch.empty(1, device="cuda")
    seam = seam_mod.build(device)
    parts["card"] = time.perf_counter() - t

    t = time.perf_counter()
    from stellar_core_tpu_torch.native.loader import get_lib
    corpus = corpus_mod.build(cell.config, cell.traffic, seed, get_lib())
    parts["corpus"] = time.perf_counter() - t

    run = Run(cell, corpus, seconds)
    verdicts = Verdicts(corpus, seam)
    t = time.perf_counter()
    cell.loop.warm_up(seam, corpus, cell.traffic, verdicts)
    if on_card:
        torch.cuda.synchronize()
    parts["warm_up"] = time.perf_counter() - t

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        mark = record_function
    else:
        mark = None
    run.setup_s = process_age()
    run.t_open = time.perf_counter()
    run.t_close = run.t_open + seconds
    with (mark("window") if mark else contextlib.nullcontext()):
        cell.loop.drive(seam, corpus, cell.traffic, verdicts, run.t_close,
                        mark=mark, run=run)
    if prof is not None:
        if on_card:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    forbidden = _forbidden_modules()
    if forbidden:
        raise BenchError("modules loaded in the run: " + ", ".join(forbidden))
    seam.close()

    if prof is not None:
        from . import trace as trace_mod
        run.trace = trace_mod.Trace(*trace_mod.read(prof))
        prof = None
        if on_card:
            from . import bounds
            run.imad_per_s = bounds.imad_per_s(
                torch.cuda.get_device_properties(0).multi_processor_count)

    checks, wrong_rows, sampled = check(run, verdicts, reference, seed)
    correct = all(v <= lim for v, lim in checks.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = len(run.batch) * run.rows
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": verdicts.fallback_rows + wrong_rows,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    log("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
        + f"; setup_s {run.setup_s:.3f} s")
    if run.batch:
        import statistics
        call = statistics.median(r - c for c, r in
                                 zip(run.t_call, run.t_return)) * 1e3
        wall = statistics.median(d - c for c, d in
                                 zip(run.t_call, run.t_collect)) * 1e3
        log(f"dispatches {len(run.batch)} of {run.rows} rows, in the window "
            f"{len(run.in_window())}; median call {call:.3f} ms, median "
            f"call to verdicts {wall:.3f} ms; reference rows {sampled}")
    lines = [f"check {k} {v} limit {lim}" for k, (v, lim) in checks.items()]
    return result, lines


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
        cell = Cell(bench, args.workload)
        import torch
        if not torch.cuda.is_available():
            raise BenchError("no CUDA card")
        if torch.cuda.device_count() < cell.chips:
            raise BenchError(f"{cell.name} needs {cell.chips} cards, "
                             f"{torch.cuda.device_count()} visible")
        result, lines = run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace))
    except BenchError as e:
        print(f"seam_bench: {e}", file=sys.stderr, flush=True)
        return 2
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
