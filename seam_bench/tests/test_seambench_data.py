"""The harness finds a configuration, a traffic mix, its loop and a metric
by name: a later change adds a cell by adding files and entries, editing
none."""

import json
import os
import shutil
import subprocess
import sys

from _seambench import ROOT, SEED

NEW_METRIC = '''"""dispatches_per_s.tiny: dispatches completed per second of the window."""


def read(run):
    return len(run.in_window()) / run.seconds
'''

NEW_LOOP = '''"""serial: the closed loop with one dispatch out at a time."""

from seam_bench.loops import closed


def warm_up(seam, corpus, traffic, verdicts):
    closed.warm_up(seam, corpus, dict(traffic, in_flight=1), verdicts)


def drive(seam, corpus, traffic, verdicts, t_end, **kw):
    closed.drive(seam, corpus, dict(traffic, in_flight=1), verdicts, t_end,
                 **kw)
'''

RUN = '''
import json, sys
sys.path[:0] = [{copy!r}, {root!r}]
from seam_bench import harness
assert harness.ROOT == {copy!r}, harness.ROOT
bench = harness.load_json({copy!r} + "/BENCHMARK.json")
for trace in (False, True):
    cell = harness.Cell(bench, "tiny.cell")
    result, _ = harness.run_cell(cell, {seed}, 0.5, trace, device="cpu",
                                 log=lambda m: None)
    print(json.dumps(result))
'''


def test_new_files_make_a_new_cell(tmp_path):
    copy = str(tmp_path / "checkout")
    os.makedirs(copy)
    shutil.copytree(os.path.join(ROOT, "seam_bench"),
                    os.path.join(copy, "seam_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    sb = os.path.join(copy, "seam_bench")
    conf = json.load(open(os.path.join(sb, "configs",
                                       "pubnet-catchup.json")))
    conf.update(accounts=8, reference_rows=4)
    json.dump(conf, open(os.path.join(sb, "configs", "tiny-config.json"),
                         "w"))
    json.dump({"why": "tiny", "loop": "serial", "rows_per_dispatch": 4,
               "distinct_batches": 5},
              open(os.path.join(sb, "traffic", "tiny.json"), "w"))
    with open(os.path.join(sb, "loops", "serial.py"), "w") as f:
        f.write(NEW_LOOP)
    with open(os.path.join(sb, "metrics", "dispatches_per_s.tiny.py"),
              "w") as f:
        f.write(NEW_METRIC)
    bench["configs"].append({"name": "tiny-config", "source": "a test",
                             "file": "seam_bench/configs/tiny-config.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny-config",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("tiny.cell")
    bench["per_layer"].append({
        "name": "dispatches_per_s.tiny", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "supervisor and host prep",
        "moves": "verifies_per_s", "workloads": ["tiny.cell"]})
    json.dump(bench, open(os.path.join(copy, "BENCHMARK.json"), "w"))
    p = subprocess.run(
        [sys.executable, "-c", RUN.format(copy=copy, root=ROOT, seed=SEED)],
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    untraced, traced = [json.loads(x) for x in p.stdout.splitlines()[-2:]]
    assert untraced["correct"] and traced["correct"]
    assert set(untraced["metrics"]) == {"verifies_per_s", "setup_s"}
    assert "dispatches_per_s.tiny" in traced["metrics"]
    assert traced["metrics"]["dispatches_per_s.tiny"]["unit"] == "1/s"
    # one in flight over five batches of four rows
    assert untraced["attempted"] % 4 == 0
