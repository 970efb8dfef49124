"""Shared helpers of the benchmark's own tests: tiny cells run on the CPU
through the program's plain versions."""

import copy
import os
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(TESTS))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from seam_bench import harness  # noqa: E402

CELLS = ("catchup.fused128k",)
SEED = 2147483999


def tiny_cell(name, rows=8, batches=2, invalid_share=0.25,
              invalid_kinds=None):
    """The cell with `rows` rows per dispatch. Below the node's device
    cutoff (16 rows) the seam serves a dispatch from the host's verifier;
    at 16 or more the program's plain versions run."""
    cell = harness.Cell(harness.load_json(
        os.path.join(ROOT, "BENCHMARK.json")), name)
    cell.traffic = dict(cell.traffic, rows_per_dispatch=rows,
                        distinct_batches=batches)
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(invalid_share=invalid_share, reference_rows=8,
                       accounts=16)
    if invalid_kinds:
        cell.config["invalid_kinds"] = invalid_kinds
    return cell


def run_tiny(cell, seconds=0.5, trace=False, seed=SEED):
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            log=lambda msg: None)
