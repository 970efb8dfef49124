"""Wide-area survival scenario matrix.

Cells over {topology tier, load shape, surge, partition window, flap
window, slow-link shape, sick-device window}, each one a REAL
process-per-node cluster of the port's nodes
(stellar_core_tpu_torch/simulation/cluster.run_matrix_cell) with a
typed verdict doc: survival_ok / rejoin_ok / safety_ok / slo_ok /
crashes. The MATRIX artifact's headline value is the fraction of cells
whose composite verdict held, so the regression gate
(scripts/bench_trend.py) trips when a future change makes previously
surviving cells fail — exactly the "chaos scenario that used to pass
now fails" regression this matrix exists to catch.

    python -m stellar_core_tpu_torch.scripts.bench_matrix [--smoke] \
        [--cell NAME]

The counterpart of the JAX package's scripts/bench_matrix.py: the same
cells, failed-cell doc and artifact folding, over the port's cluster
harness. Its nodes run at the default verify backend, "native", so it
launches no kernel. It prints the artifact and writes nothing into
the repository.
``tests/test_torch_matrix.py`` holds its cells, docs and artifact to the
reference's schema.
"""

import json
import os
import shutil
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _REPO not in sys.path:            # standalone invocation
    sys.path.insert(0, _REPO)

# the last committed CLUSTER duplicate_ratio before per-link SCP digest
# gating (CLUSTER_r12): the floor the backpressure/slow-link cell's
# ratio is compared against
DUPLICATE_BASELINE_R12 = 0.714

# typed per-cell verdict keys the MATRIX schema checks
# (scripts/check_artifacts.py _MATRIX_CELL_KEYS mirrors this)
CELL_VERDICT_KEYS = ("survival_ok", "rejoin_ok", "safety_ok",
                     "slo_ok", "crashes", "nodes", "ok")


def default_cells(scale: str = "default") -> list:
    """The committed matrix: six single-validator-per-org smoke tiers
    (one per fault family, fast enough to run serially on a loaded
    1-core host) plus the scaled 24-process tiered cell. ``--smoke``
    drops the 24-process cell."""
    cells = [
        # baseline: no fault — the matrix's control cell; a survival
        # regression here means the harness itself broke
        {"name": "smoke_uniform", "n_orgs": 3, "validators_per_org": 1,
         "close_time": 1.0, "load": "uniform", "accounts": 40,
         "rounds": 1, "txs_per_round": 80, "target_slots": 3},
        # Zipf-skewed load + an oversized surge burst: hot-account
        # contention while the admission path sheds
        {"name": "zipf_surge", "n_orgs": 3, "validators_per_org": 1,
         "close_time": 1.0, "load": "zipf", "zipf_exponent": 1.2,
         "accounts": 60, "rounds": 1, "txs_per_round": 80,
         "surge": 240, "target_slots": 3},
        # cut org 0 off the quorum for a window: majority must keep
        # externalizing, minority must stall WITHOUT crashing and
        # rejoin byte-identically after heal
        {"name": "smoke_partition", "n_orgs": 3,
         "validators_per_org": 1, "close_time": 1.0,
         "load": "uniform", "accounts": 40, "rounds": 1,
         "txs_per_round": 60, "target_slots": 3,
         "partition": {"window_s": 10.0, "rejoin_s": 180.0}},
        # one node's links cycle down/up under load: degrade, never
        # detach — the node catches back up after the window
        {"name": "smoke_flap", "n_orgs": 3, "validators_per_org": 1,
         "close_time": 1.0, "load": "uniform", "accounts": 40,
         "rounds": 1, "txs_per_round": 60, "target_slots": 3,
         "flap": {"window_s": 9.0, "period_s": 3.0, "duty": 0.4,
                  "txs": 60, "rejoin_s": 150.0}},
        # WAN latency + a bandwidth cap on every real socket: the
        # backpressure cell — queues must stay inside their byte
        # budget with SCP never shed before tx gossip
        {"name": "smoke_slowlink", "n_orgs": 3,
         "validators_per_org": 1, "close_time": 1.0,
         "load": "uniform", "accounts": 40, "rounds": 1,
         "txs_per_round": 60, "target_slots": 3,
         "slow_link": {"intra_org_ms": 2.0,
                       "cross_org_ms": [25.0, 90.0],
                       "bps": 2_000_000.0, "window_s": 12.0,
                       "txs": 60}},
        # trip one node's accelerator breaker for a window: consensus
        # must ride through a sick device like any other slow node
        {"name": "sick_device", "n_orgs": 3, "validators_per_org": 1,
         "close_time": 1.0, "load": "uniform", "accounts": 40,
         "rounds": 1, "txs_per_round": 60, "target_slots": 3,
         "sick_device": {"hold_s": 2.0}},
    ]
    if scale != "smoke":
        # the scaled cell: 24 real processes on the tiered topology.
        # Budgets are sized for a saturated single-core host — slots
        # are slow, not absent
        cells.append(
            {"name": "full_tiered_24", "n_orgs": 6,
             "validators_per_org": 4, "close_time": 2.0,
             "load": "uniform", "accounts": 30, "rounds": 1,
             "txs_per_round": 60, "target_slots": 3,
             "boot_deadline_s": 420.0, "chaos_seed": 24})
    return cells


def _failed_cell(cell: dict, err: str) -> dict:
    """A cell whose harness died still ships a TYPED verdict doc —
    the matrix artifact's schema holds even for wrecked cells."""
    return {"name": cell["name"],
            "nodes": int(cell.get("n_orgs", 3))
            * int(cell.get("validators_per_org", 1)),
            "survival_ok": False, "rejoin_ok": False,
            "safety_ok": False, "slo_ok": False,
            "crashes": 0, "ok": False, "error": err,
            "faults": []}


def run_matrix(root_dir: str, cells: list, keep_failed: bool = True
               ) -> list:
    """Run every cell serially (each one is itself N processes; on a
    small host two overlapping clusters would starve each other),
    keeping a failed cell's node tree — sqlite/buckets/logs plus each
    node's input.rec replay log — under ``root_dir/<cell>``."""
    from stellar_core_tpu_torch.simulation.cluster import run_matrix_cell

    results = []
    for cell in cells:
        cell_dir = os.path.join(root_dir, cell["name"])
        os.makedirs(cell_dir, exist_ok=True)
        print(f"matrix cell {cell['name']} ...", file=sys.stderr,
              flush=True)
        try:
            doc = run_matrix_cell(cell_dir, cell)
        except Exception as e:
            doc = _failed_cell(cell, repr(e))
            doc["state_dir"] = cell_dir
        if doc.get("ok"):
            shutil.rmtree(cell_dir, ignore_errors=True)
            doc.pop("record_paths", None)   # paths just got deleted
        elif keep_failed:
            doc["state_dir"] = cell_dir
            print(f"matrix cell {cell['name']} FAILED; node state + "
                  f"replay logs kept under {cell_dir}",
                  file=sys.stderr, flush=True)
        results.append(doc)
        print(f"matrix cell {cell['name']}: "
              f"ok={doc.get('ok')} survival={doc.get('survival_ok')} "
              f"rejoin={doc.get('rejoin_ok')} "
              f"safety={doc.get('safety_ok')} "
              f"slo={doc.get('slo_ok')} crashes={doc.get('crashes')} "
              f"wall={doc.get('wall_s')}s",
              file=sys.stderr, flush=True)
    return results


def matrix_artifact(results: list) -> dict:
    """Fold per-cell verdicts into the MATRIX artifact core. Headline
    value = fraction of cells passing (higher is better), which is
    what rides the bench_trend regression gate."""
    total = len(results)
    ok = sum(1 for r in results if r.get("ok"))
    # the backpressure/duplicate evidence comes from the shaped cell
    # when it ran, else the best multi-node cell that reported one
    ratios = [r.get("duplicate_ratio") for r in results
              if isinstance(r.get("duplicate_ratio"), (int, float))]
    dup = (min(ratios) if ratios else None)
    return {
        "metric": "matrix_cells_pass_fraction",
        "value": round(ok / total, 3) if total else 0.0,
        "unit": "fraction_cells_ok",
        "vs_baseline": round(ok / total, 3) if total else 0.0,
        "cells_total": total,
        "cells_ok": ok,
        "cells_failed": total - ok,
        "max_nodes": max((r.get("nodes", 0) for r in results),
                         default=0),
        "crashes_total": sum(r.get("crashes", 0) for r in results),
        "duplicate_ratio_best": dup,
        "duplicate_baseline_r12": DUPLICATE_BASELINE_R12,
        "duplicate_vs_r12": round(dup / DUPLICATE_BASELINE_R12, 3)
        if dup is not None else None,
        "cells": results,
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    scale = "smoke" if "--smoke" in argv else "default"
    cells = default_cells(scale)
    if "--cell" in argv:
        want = argv[argv.index("--cell") + 1]
        cells = [c for c in cells if c["name"] == want]
        if not cells:
            print(f"unknown cell: {want}", file=sys.stderr)
            return 2
    root = tempfile.mkdtemp(prefix="bench-matrix-")
    art = matrix_artifact(run_matrix(root, cells))
    if art["cells_failed"] == 0:
        shutil.rmtree(root, ignore_errors=True)
    json.dump(art, sys.stdout)
    print()
    return 0 if art["cells_failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
