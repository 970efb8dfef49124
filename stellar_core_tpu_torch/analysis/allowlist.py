"""Allowlist: every suppression carries a one-line justification.

Format (stellar_core_tpu_torch/analysis/ALLOWLIST, one entry per line):

    <finding-key>  # <why this is not a bug>

Blank lines and lines starting with ``#`` are comments. An entry with
no justification after ``#`` is itself a finding (silent suppressions
are not acceptable), and an entry that matched nothing in
the current run is a finding too, so the allowlist can only shrink or
stay justified, never rot.

Keys are stable (module + qualname + source / attr / name — never
line numbers), so a reformat does not invalidate entries. A trailing
``*`` in a key segment-wise matches any suffix, for families like
``determinism:util.timer:VirtualClock.crank:*``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from .astgraph import Finding


@dataclass
class Allowlist:
    path: str
    entries: Dict[str, str]          # key -> justification


def load_allowlist(path: str) -> Allowlist:
    entries: Dict[str, str] = {}
    with open(path, encoding="utf-8") as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            key, _, just = line.partition("#")
            entries[key.strip()] = just.strip()
    return Allowlist(path=path, entries=entries)


def _matches(entry_key: str, finding_key: str) -> bool:
    if entry_key == finding_key:
        return True
    if entry_key.endswith("*"):
        return finding_key.startswith(entry_key[:-1])
    return False


def apply_allowlist(findings: List[Finding], allow: Allowlist,
                    ) -> Tuple[List[Finding], List[Finding],
                               List[Finding]]:
    """(live findings, suppressed findings, allowlist-meta findings)."""
    live: List[Finding] = []
    suppressed: List[Finding] = []
    used: set = set()
    for f in findings:
        hit = None
        for key, just in allow.entries.items():
            if _matches(key, f.key):
                hit = (key, just)
                break
        if hit is None:
            live.append(f)
            continue
        used.add(hit[0])
        suppressed.append(f)
    meta: List[Finding] = []
    for key, just in allow.entries.items():
        if not just:
            meta.append(Finding(
                pass_name="allowlist", key=f"allowlist:unjustified:{key}",
                path=allow.path, lineno=0,
                message=f"allowlist entry {key!r} has no justification",
                hint="append '# <one-line reason>' — silent "
                     "suppressions are not acceptable"))
        elif key not in used:
            meta.append(Finding(
                pass_name="allowlist", key=f"allowlist:unused:{key}",
                path=allow.path, lineno=0,
                message=f"allowlist entry {key!r} matched no finding "
                        "in this run",
                hint="the suppressed code is gone or renamed — delete "
                     "the entry so the allowlist cannot rot"))
    return live, suppressed, meta
