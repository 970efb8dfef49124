"""The check fails where the timed path is wrong: the control (the
program's own path with its strict flags off) and each fault a cell can
have, with the harness's look for a card skipped (the program's plain
versions on the CPU, 16 rows a dispatch: the node's device cutoff).

The control at each cell's own size runs on the card
(`test_control_on_the_card`, marked gpu)."""

import json
import os

import pytest

from _seambench import CELLS, SEED, harness, run_tiny, tiny_cell

from seam_bench import control


def _cell(kinds):
    return tiny_cell(CELLS[0], rows=16, batches=2,
                     invalid_share=0.25, invalid_kinds=kinds)


def test_sound_path_is_correct():
    result, _ = run_tiny(_cell(["s_plus_l", "flip_r", "flip_s"]), 0.1)
    assert result["correct"] is True
    assert all(c["value"] == 0 for c in result["checks"].values())


@pytest.mark.parametrize("kind,kinds", [
    ("lax", ["s_plus_l"]),
    ("half_left_out", ["flip_r"]),
    ("answer_altered", ["flip_s"]),
    ("stale", ["flip_r"]),
])
def test_broken_path_is_not_correct(kind, kinds):
    with control.broken(kind):
        result, _ = run_tiny(_cell(kinds), 0.1)
    assert result["correct"] is False
    assert result["checks"]["verdict_mismatch"]["value"] > 0
    assert result["failed"] > 0


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["lax", "stale"])
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(card, name, kind):
    """The control and the stale fault at the cell's own size, on three
    seeds; prints each run's checks (pytest -s) for the limits' upper
    readings."""
    cell = harness.Cell(harness.load_json(
        os.path.join(harness.ROOT, "BENCHMARK.json")), name)
    for seed in (SEED, SEED + 1, SEED + 2):
        with control.broken(kind):
            result, _ = harness.run_cell(cell, seed, 2.0, False)
        print(json.dumps({"workload": name, "control": kind, "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}))
        assert result["correct"] is False
