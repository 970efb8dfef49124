"""Pass 1 — determinism reachability.

Nondeterminism sources are flagged when the function containing them
is *reachable from a consensus root* through the call graph — the
upgrade over the retired directory-list grep, which a wall-clock read
in a ``util/`` helper imported into ``ledger/`` provably escaped.

Roots (the functions whose output every validator must reproduce
bit-for-bit given the same inputs):

- ``LedgerManager.close_ledger`` / ``_close_ledger``  (ledger close)
- ``Slot.process_envelope``                           (SCP slot processing)
- ``TransactionFrame.apply``                          (tx apply)
- ``merge_buckets``                                   (bucket merge)

Source kinds and their severities:

- ``wallclock`` (time.time / datetime.now):  flagged when reachable.
- ``random`` (module-level random.*, os.urandom, np.random, secrets,
  uuid1/4, unseeded ``random.Random()``): flagged when reachable.
  Seeded ``random.Random(seed)`` instances are deterministic and pass.
- ``set-iter``: iteration over a set literal / ``set(...)`` /
  set-comprehension in reachable code — Python set order is
  hash-seed-dependent, so anything it feeds (hashing, XDR
  serialization, tx ordering) varies run to run. ``sorted(set(...))``
  does not match.
- ``sleep`` (time.sleep): flagged EVERYWHERE in the package, not just
  reachable code — a real sleep under a VirtualClock simulation
  blocks every simulated node at once (the old
  ``_SIM_REACHABLE_CHAOS_PATHS`` lint, strengthened from a file list
  to the whole tree). Legitimate uses (REAL_TIME idle waits,
  config-gated test knobs) carry allowlist justifications.
- ``monotonic`` (+ wallclock): flagged in *strict modules* regardless
  of reachability — ops/controller.py must replay decisions from
  sample timestamps alone, so even perf_counter is banned
  there.

Allowlist keys: ``determinism:<module>:<qualname>:<source>``.
"""

from __future__ import annotations

from typing import List

from .astgraph import Finding, PackageIndex

# consensus roots: (module suffix, qualname)
ROOTS = (
    ("ledger.ledger_manager", "LedgerManager.close_ledger"),
    ("ledger.ledger_manager", "LedgerManager._close_ledger"),
    ("scp.slot", "Slot.process_envelope"),
    ("tx.frame", "TransactionFrame.apply"),
    ("bucket.bucket", "merge_buckets"),
)

# modules whose own timing reads must come from telemetry samples or
# recorded inputs, never any clock — monotonic/perf_counter included.
# ops.controller: decisions must replay from sample `t` alone.
# The replay subsystem: a wallclock/random
# read in the recorder or the replay driver would make two replays of
# the same log legally diverge, which is the one thing it exists to
# forbid — every timestamp must come from the VirtualClock via the
# log, every random choice from recorded bytes.
STRICT_MODULES = ("ops.controller", "replay.log", "replay.recorder",
                  "replay.replayer", "replay.scenario")

_REACHABLE_KINDS = ("wallclock", "random", "set-iter")

_HINTS = {
    "wallclock": "close results must not depend on when they run — "
                 "take time from the VirtualClock / the externalized "
                 "StellarValue closeTime",
    "random": "use the seeded helpers in util/rand.py (or a "
              "random.Random(seed) instance) so every validator draws "
              "the same sequence",
    "set-iter": "set order is hash-seed-dependent; sort before "
                "iterating (sorted(...)) or use an ordered container",
    "sleep": "real sleeps block every simulated node at once — ride "
             "the VirtualClock (chaos.Delay / schedule_at) instead",
    "monotonic": "the adaptive controller must replay decisions from "
                 "sample `t` alone; no clock reads of its own",
}


def run(index: PackageIndex) -> List[Finding]:
    findings: List[Finding] = []
    root_keys = []
    for mod, qual in ROOTS:
        key = index.find_func(mod, qual)
        if key is None:
            findings.append(Finding(
                pass_name="determinism",
                key=f"determinism:root-missing:{mod}:{qual}",
                path=index.pkg_root, lineno=0,
                message=f"consensus root {mod}.{qual} not found — the "
                        "analyzer's root list drifted from the code",
                hint="update ROOTS in analysis/determinism.py"))
            continue
        root_keys.append(key)
    parents = index.reachable_from(root_keys)

    for key, fn in sorted(index.funcs.items()):
        reachable = key in parents
        strict = any(fn.module == m or fn.module.endswith("." + m)
                     for m in STRICT_MODULES)
        for occ in fn.nondet:
            flag = False
            kind = occ.kind
            if kind in _REACHABLE_KINDS and reachable:
                flag = True
            elif kind == "sleep":
                flag = True          # package-wide, allowlist the rest
            elif strict and kind in ("wallclock", "monotonic",
                                     "random"):
                flag = True
                if kind == "wallclock":
                    kind = "monotonic"  # strict-module hint applies
            if not flag:
                continue
            chain = index.chain(parents, key) if reachable else []
            findings.append(Finding(
                pass_name="determinism",
                key=f"determinism:{fn.module}:{fn.qualname}:{occ.source}",
                path=fn.path, lineno=occ.lineno,
                message=f"{occ.source} in {fn.module}.{fn.qualname}"
                        + (" (reachable from consensus root)"
                           if reachable else
                           (" (strict module)" if strict else "")),
                hint=_HINTS[kind], chain=chain))
    return _dedupe(findings)


def _dedupe(findings: List[Finding]) -> List[Finding]:
    seen = {}
    for f in findings:
        k = (f.key, f.lineno)
        if k not in seen:
            seen[k] = f
    return list(seen.values())
