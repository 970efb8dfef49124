"""Each cell runs end to end at a tiny size and prints a line that keeps
to the benchmark's contract; a run without a card prints nothing."""

import json
import math

import pytest

from _seambench import CELLS, harness, run_tiny, tiny_cell

TOP_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_line_keeps_to_the_contract(name, trace):
    cell = tiny_cell(name)
    result, lines = run_tiny(cell, trace=bool(trace))
    line = json.loads(json.dumps(result))
    keys = list(line)
    assert keys[:5] == TOP_KEYS and keys[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    listed = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in listed}
    assert set(line["metrics"]) <= set(units)
    for name_, m in line["metrics"].items():
        assert m["unit"] == units[name_]
        assert math.isfinite(m["value"])
    if not trace:
        # every end-to-end metric is read in an untraced run
        assert set(line["metrics"]) == set(units)
        assert line["metrics"]["setup_s"]["value"] > 0
    else:
        assert "breakdown" in line
        assert line["device"]["window_s"] > 0
        assert any(k.startswith("host_dispatch_ms") for k in line["metrics"])
    for k, c in line["checks"].items():
        assert c["value"] <= c["limit"], k
    assert lines == [f"check {k} {c['value']} limit {c['limit']}"
                     for k, c in line["checks"].items()]


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", CELLS[0], "--seed", "1",
                       "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    assert "no CUDA card" in out.err


def test_unknown_workload_no_result(capsys):
    rc = harness.main(["--workload", "no.such", "--seed", "1",
                       "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_same_seed_same_rows():
    from seam_bench import corpus
    from stellar_core_tpu_torch.native.loader import get_lib
    cell = tiny_cell(CELLS[0], rows=16)
    a = corpus.build(cell.config, cell.traffic, 2**31 + 7, get_lib())
    b = corpus.build(cell.config, cell.traffic, 2**31 + 7, get_lib())
    c = corpus.build(cell.config, cell.traffic, 2**31 + 8, get_lib())
    assert a.batches == b.batches and a.labels == b.labels
    assert a.batches != c.batches
    for batch in a.batches:
        assert len(set(batch)) == len(batch)
    # the batches hold the same signed rows, in other orders and with
    # other rows broken
    assert a.batches[0] != a.batches[1] and a.labels[0] != a.labels[1]
    assert {r[2] for r in a.batches[0]} == {r[2] for r in a.batches[1]}
    # the share of broken rows is fixed by the files, not by the seed
    assert [lab.count(False) for lab in a.labels] \
        == [lab.count(False) for lab in c.labels] == [4, 4]
