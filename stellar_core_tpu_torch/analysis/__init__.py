"""AST-based static analysis for determinism and thread-domain safety.

Three passes over the whole package (docs/ANALYSIS.md):

- Pass 1 (`determinism`): nondeterminism sources *reachable from
  consensus roots* through the import/call graph — the reachability
  upgrade over the old `tests/test_determinism_lint.py` directory
  greps, which a `util/` helper imported into `ledger/` sailed past.
- Pass 2 (`domains`): declared thread domains propagated through the
  call graph; cross-domain writes to shared attributes without a
  lock / `clock.post(...)` are flagged — the bug class
  of admin HTTP commands racing the crank loop, at analysis time.
- Pass 3 (`registry`): chaos seam names, metric names and config
  knobs cross-checked against their documented registries; drift in
  either direction fails with the missing name.

Entry points: ``scripts/analyze.py`` (CLI, --json artifact mode) and
``run_all()`` here (what the tier-1 tests call).
"""

from __future__ import annotations

import os
from typing import List, Optional

from .astgraph import Finding, PackageIndex, build_index
from .allowlist import Allowlist, load_allowlist, apply_allowlist
from . import determinism, domains, registry

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_ALLOWLIST = os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "ALLOWLIST")


def run_all(pkg_root: Optional[str] = None,
            repo_root: Optional[str] = None,
            allowlist_path: Optional[str] = DEFAULT_ALLOWLIST,
            passes: tuple = ("determinism", "domains", "registry"),
            ) -> "AnalysisResult":
    """Run the selected passes; returns findings after allowlisting."""
    repo_root = repo_root or REPO_ROOT
    pkg_root = pkg_root or os.path.join(repo_root, "stellar_core_tpu_torch")
    index = build_index(pkg_root)
    raw: List[Finding] = []
    if "determinism" in passes:
        raw.extend(determinism.run(index))
    if "domains" in passes:
        raw.extend(domains.run(index))
    if "registry" in passes:
        raw.extend(registry.run(index, repo_root))
    if allowlist_path and os.path.isfile(allowlist_path):
        allow = load_allowlist(allowlist_path)
    else:
        allow = Allowlist(path=allowlist_path or "<none>", entries={})
    findings, suppressed, meta = apply_allowlist(raw, allow)
    return AnalysisResult(index=index, findings=findings + meta,
                          suppressed=suppressed, allowlist=allow)


class AnalysisResult:
    def __init__(self, index: PackageIndex, findings: List[Finding],
                 suppressed: List[Finding], allowlist: Allowlist):
        self.index = index
        self.findings = findings       # live findings incl. allowlist rot
        self.suppressed = suppressed   # true positives with justification
        self.allowlist = allowlist

    def counts(self) -> dict:
        out: dict = {}
        for f in self.findings:
            out[f.pass_name] = out.get(f.pass_name, 0) + 1
        return out

    def to_json(self) -> dict:
        sup: dict = {}
        for f in self.suppressed:
            sup[f.pass_name] = sup.get(f.pass_name, 0) + 1
        return {
            "findings": [f.to_json() for f in self.findings],
            "suppressed": [f.to_json() for f in self.suppressed],
            "counts": self.counts(),
            "suppressed_counts": sup,
            "allowlist_size": len(self.allowlist.entries),
            "modules": len(self.index.modules),
            "functions": len(self.index.funcs),
        }
