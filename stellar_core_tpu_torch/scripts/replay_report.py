#!/usr/bin/env python3
"""Divergence-diffing flight-recorder report.

Aligns two replay traces event-for-event and pinpoints the first
diverging span/instant, emitting the result in the static analyzer's
findings format (pass/key/path/line/message/hint/chain — the same
shape the analyze script renders), so a replay divergence reads like
any other determinism finding: a precise location plus the evidence
chain of the last agreed-on events leading up to the fork.

    python -m stellar_core_tpu_torch.scripts.replay_report NODE.rlog
        # replay twice, diff
    python -m stellar_core_tpu_torch.scripts.replay_report A.rlog B.rlog
        # replay each, diff
    python -m stellar_core_tpu_torch.scripts.replay_report A.json B.json
        # diff trace dumps
    ... --json                                    # machine output

A trace dump is a JSON list of normalized events
``[phase, name, args_json, correlation_id]`` — what
``replay_report.dump_trace`` writes and what
``stellar_core_tpu_torch.replay.replayer.normalize_trace`` produces.
Exit status: 0 = zero diff, 1 = divergence found, 2 = usage/load error.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

CONTEXT = 8


def dump_trace(trace) -> str:
    """Serialize a normalized trace (list of 4-tuples) to JSON."""
    return json.dumps([list(e) for e in trace])


def _load_trace(path: str):
    """A path is either a binary input log (replayed to produce its
    trace) or a JSON trace dump."""
    from stellar_core_tpu_torch.replay import log as rlog
    from stellar_core_tpu_torch.replay.replayer import replay_log
    with open(path, "rb") as f:
        head = f.read(len(rlog.MAGIC))
    if head == rlog.MAGIC:
        res = replay_log(rlog.InputLog.load(path), trace=True)
        return res.trace
    with open(path) as f:
        return [tuple(e) for e in json.load(f)]


def _render(event) -> str:
    if event is None:
        return "<absent>"
    ph, name, args, cid = event
    out = f"{ph} {name}"
    if args:
        out += f" {args}"
    if cid:
        out += f" [{cid}]"
    return out


def divergence_finding(div: dict, path_a: str, path_b: str) -> dict:
    """Project a ``first_divergence`` result onto the analyzer's
    findings format. ``line`` is the trace event index — the instant
    the runs fork; ``chain`` is the shared evidence trail up to it."""
    idx = div["index"]
    if div.get("tail_only_in"):
        longer = path_a if div["tail_only_in"] == "a" else path_b
        message = ("traces diverge at event %d: one trace ends, %s "
                   "continues with %s" %
                   (idx, os.path.basename(longer),
                    _render(div["a"] or div["b"])))
    else:
        message = ("traces diverge at event %d: %s != %s" %
                   (idx, _render(div["a"]), _render(div["b"])))
    return {
        "pass": "replay-divergence",
        "key": "replay:divergence:%d" % idx,
        "path": path_a,
        "line": idx,
        "message": message,
        "hint": "the last agreed-on events are in `chain`; replay the "
                "input log under a debugger and break at that instant "
                "— a diverging replay means a nondeterministic input "
                "(mutated log, unrecorded source) or a determinism "
                "bug the analyzer passes missed (docs/REPLAY.md)",
        "chain": [_render(e) for e in div.get("chain", [])],
    }


def run(argv) -> dict:
    """Library entry: returns {divergence, findings, lengths}."""
    from stellar_core_tpu_torch.replay.replayer import first_divergence
    if len(argv) == 1:
        a = _load_trace(argv[0])
        b = _load_trace(argv[0])
        path_a, path_b = argv[0] + "#replay1", argv[0] + "#replay2"
    else:
        a = _load_trace(argv[0])
        b = _load_trace(argv[1])
        path_a, path_b = argv[0], argv[1]
    div = first_divergence(a, b, context=CONTEXT)
    findings = [] if div is None else \
        [divergence_finding(div, path_a, path_b)]
    return {"divergence": div, "findings": findings,
            "lengths": [len(a), len(b)]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    if not 1 <= len(argv) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    try:
        out = run(argv)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print("replay_report: %s" % e, file=sys.stderr)
        return 2
    if as_json:
        print(json.dumps(out, indent=2, default=str))
    elif out["findings"]:
        f = out["findings"][0]
        print("[%s] %s:%d: %s" % (f["pass"], f["path"], f["line"],
                                  f["message"]))
        print("    hint: %s" % f["hint"])
        for e in f["chain"]:
            print("    via:  %s" % e)
    else:
        print("zero diff: %d events in both traces" % out["lengths"][0])
    return 1 if out["findings"] else 0


if __name__ == "__main__":
    sys.exit(main())
