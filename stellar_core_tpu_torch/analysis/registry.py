"""Pass 3 — registry cross-checks: chaos seams, metrics, config knobs.

Three registries that historically drift silently, checked in BOTH
directions so either side going stale fails with the missing name:

- **Chaos seams.** Names fired at ``chaos.point("...")`` call sites
  (plus the ``CLOSE_CRASH_POINTS`` tuple, fired dynamically by the
  close path) vs names referenced by ``FaultSpec("...")``
  constructions in the package, tests, scripts and docs/CHAOS.md.
  A referenced-but-never-fired seam is a typo in a test — it would
  silently inject nothing — and always fails. A fired-but-never-
  referenced seam is dead instrumentation (allowlistable:
  ``seam:<name>``).
- **Metrics.** Names emitted through the MetricsRegistry (parts-style
  ``metrics.counter("a", "b")`` and ``new_*("a.b")``) vs dotted names
  documented in docs/OBSERVABILITY.md. Dynamic parts (loop variables)
  become ``*`` wildcards; doc-side ``{a,b}`` brace alternation and
  ``<placeholder>`` forms expand/normalize the same way. Emitted-but-
  undocumented is allowlistable (``metric:<name>``); documented-but-
  not-emitted always fails (the doc promises a metric nothing
  produces).
- **Config knobs.** UPPER_SNAKE ``self.X = ...`` assignments in
  ``Config.__init__`` vs backticked knob names inside markdown tables
  in docs/. Undocumented knob: allowlistable (``knob:<NAME>``);
  documented-but-nonexistent knob always fails.
"""

from __future__ import annotations

import ast
import glob
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from .astgraph import Finding, PackageIndex, _dotted

_METRIC_METHODS = {"counter", "meter", "timer", "histogram"}
_METRIC_NEW = {"new_counter", "new_meter", "new_timer", "new_histogram"}
_METRIC_RECV = re.compile(r"(^|\.)_?metrics$")
_BACKTICK_DOTTED = re.compile(r"`([a-z0-9_*{},<>-]+(?:\.[A-Za-z0-9_*{},<>-]+)+)`")
_KNOB_RE = re.compile(r"`([A-Z][A-Z0-9_]{2,})`")
_SELF_KNOB = re.compile(r"^[A-Z][A-Z0-9_]{2,}$")
_FAULTSPEC_RE = re.compile(r"FaultSpec\(\s*[\"']([a-z0-9_.*-]+)[\"']")
# real seam names are dotted (overlay.send) — the chaos engine's own
# unit tests fire synthetic dotless points ("p", "io") that are not
# registry members
_SEAM_NAME = re.compile(r"^[a-z0-9_-]+(\.[a-zA-Z0-9_*-]+)+$")
_DOC_SEAM_RE = re.compile(r"`([a-z0-9_-]+(?:\.[a-zA-Z0-9_*-]+)+)`")


def run(index: PackageIndex, repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    findings.extend(_check_seams(index, repo_root))
    findings.extend(_check_metrics(index, repo_root))
    findings.extend(_check_knobs(index, repo_root))
    return findings


# ----------------------------------------------------------------- seams --

def _check_seams(index: PackageIndex, repo_root: str) -> List[Finding]:
    fired: Dict[str, Tuple[str, int]] = {}
    for mod, tree in index.module_trees.items():
        path = index.modules[mod]
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                dotted = _dotted(node.func) or ""
                if dotted.endswith("chaos.point") or dotted == "point":
                    if node.args and isinstance(node.args[0], ast.Constant) \
                            and isinstance(node.args[0].value, str) \
                            and _SEAM_NAME.match(node.args[0].value):
                        fired.setdefault(node.args[0].value,
                                         (path, node.lineno))
            # CLOSE_CRASH_POINTS-style registries of dynamically fired
            # seam names: a module-level UPPER_SNAKE *_POINTS tuple
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and \
                            t.id.endswith("_POINTS") and \
                            isinstance(node.value, (ast.Tuple, ast.List)):
                        for elt in node.value.elts:
                            if isinstance(elt, ast.Constant) and \
                                    isinstance(elt.value, str) and \
                                    _SEAM_NAME.match(elt.value):
                                fired.setdefault(elt.value,
                                                 (path, elt.lineno))

    # strict refs (code/test FaultSpec + JSON schedules) participate in
    # BOTH directions; doc backticks are soft: they count as coverage
    # for a fired seam, but a dotted name appearing in CHAOS.md prose
    # (`chaos.ENABLED`, `time.sleep`, placeholder examples) is not
    # itself a claim that a point exists, so it never flags.
    refs: Dict[str, Tuple[str, int]] = {}
    soft_refs: Dict[str, Tuple[str, int]] = {}
    scan_files = []
    for sub in ("tests", "scripts"):
        scan_files.extend(glob.glob(os.path.join(repo_root, sub, "*.py")))
    scan_files.extend(index.modules.values())
    chaos_md = os.path.join(repo_root, "docs", "CHAOS.md")
    if os.path.isfile(chaos_md):
        scan_files.append(chaos_md)
    for path in scan_files:
        try:
            with open(path, encoding="utf-8") as fh:
                lines = fh.read().splitlines()
        except OSError:
            continue
        is_doc = path.endswith(".md")
        if is_doc:
            # docs/CHAOS.md's seam tables count as coverage —
            # `ledger.close.crash.*` covers the crash matrix
            for i, line in enumerate(lines, 1):
                for m in _DOC_SEAM_RE.finditer(line):
                    if _SEAM_NAME.match(m.group(1)):
                        soft_refs.setdefault(m.group(1), (path, i))
            continue
        # whole-text scan: FaultSpec( often breaks the line before the
        # seam-name literal, so a per-line regex misses it
        text = "\n".join(lines)
        for m in _FAULTSPEC_RE.finditer(text):
            if _SEAM_NAME.match(m.group(1)):
                refs.setdefault(m.group(1),
                                (path, text.count("\n", 0, m.start()) + 1))
        # JSON schedules: {"point": "overlay.send", ...}
        for m in re.finditer(r"[\"']point[\"']\s*:\s*"
                             r"[\"']([a-z0-9_.-]+)[\"']", text):
            if _SEAM_NAME.match(m.group(1)):
                refs.setdefault(m.group(1),
                                (path, text.count("\n", 0, m.start()) + 1))

    findings = []
    for name, (path, line) in sorted(refs.items()):
        if name in fired:
            continue
        if any(_seam_glob(name, f) for f in fired):
            continue
        findings.append(Finding(
            pass_name="registry", key=f"seamref:{name}",
            path=path, lineno=line,
            message=f"FaultSpec references seam {name!r} but no "
                    "chaos.point call site fires it",
            hint="fix the seam-name typo, or instrument the seam — a "
                 "spec naming a nonexistent point silently injects "
                 "nothing (fired seams: see analysis/registry.py)"))
    all_refs = {**soft_refs, **refs}
    for name, (path, line) in sorted(fired.items()):
        if name in all_refs or any(_seam_glob(r, name) for r in all_refs):
            continue
        findings.append(Finding(
            pass_name="registry", key=f"seam:{name}",
            path=path, lineno=line,
            message=f"chaos seam {name!r} is fired here but no test/"
                    "scenario references it",
            hint="add a FaultSpec exercising the seam (or allowlist "
                 f"'seam:{name}' with why it is covered elsewhere)"))
    return findings


def _seam_glob(pattern: str, name: str) -> bool:
    if "*" not in pattern:
        return pattern == name
    return re.fullmatch(pattern.replace(".", r"\.").replace("*", ".+"),
                        name) is not None


# --------------------------------------------------------------- metrics --

def _const_name(arg: ast.expr) -> Optional[str]:
    """Metric name from a literal, f-string or %-format expression;
    dynamic pieces become '*' (``f"overlay.demand.{k}"`` →
    ``overlay.demand.*``)."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if isinstance(arg, ast.JoinedStr):
        out = ""
        for v in arg.values:
            if isinstance(v, ast.Constant):
                out += str(v.value)
            else:
                out += "*"
        return out
    if isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Mod) and \
            isinstance(arg.left, ast.Constant) and \
            isinstance(arg.left.value, str):
        return re.sub(r"%[sdifr]", "*", arg.left.value)
    return None


def _metric_parts(node: ast.Call) -> Optional[str]:
    """Dotted name from a parts-style or new_* metric call; dynamic
    parts become '*' wildcards."""
    dotted = _dotted(node.func) or ""
    recv, _, method = dotted.rpartition(".")
    if method in _METRIC_NEW:
        if node.args:
            return _const_name(node.args[0])
        return None
    if method in _METRIC_METHODS and recv and _METRIC_RECV.search(recv):
        if not node.args:
            return None
        parts = []
        for a in node.args:
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                parts.append(a.value)
            else:
                parts.append("*")
        return ".".join(parts)
    return None


def _norm_doc_metric(raw: str) -> List[str]:
    """Expand `{a,b}` alternation, normalize `<placeholder>` to '*'."""
    raw = re.sub(r"<[^>]+>", "*", raw)
    out = [""]
    i = 0
    while i < len(raw):
        c = raw[i]
        if c == "{":
            j = raw.index("}", i)
            alts = raw[i + 1:j].split(",")
            out = [p + a for p in out for a in alts]
            i = j + 1
        else:
            out = [p + c for p in out]
            i += 1
    return out


def _metric_match(a: str, b: str) -> bool:
    """Segment-wise match where '*' matches one or more segments on
    either side (dynamic parts can expand to dotted suffixes)."""
    pa, pb = a.split("."), b.split(".")
    if "*" not in a and "*" not in b:
        return a == b
    if len(pa) != len(pb):
        # allow a trailing-or-embedded '*' to absorb length skew
        if not ("*" in pa or "*" in pb):
            return False
    # greedy regex match both directions; a lone '*' segment spans one
    # or more segments, an embedded '*' (device*) spans within one
    def rx(parts):
        return "".join(
            (r"[^\s`]+" if p == "*" else
             re.escape(p).replace(r"\*", r"[^.\s`]*")) + (r"\." if k <
             len(parts) - 1 else "")
            for k, p in enumerate(parts))
    return re.fullmatch(rx(pa), b) is not None or \
        re.fullmatch(rx(pb), a) is not None


def _check_metrics(index: PackageIndex, repo_root: str) -> List[Finding]:
    emitted: Dict[str, Tuple[str, int]] = {}
    for mod, tree in index.module_trees.items():
        path = index.modules[mod]
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                name = _metric_parts(node)
                if name:
                    emitted.setdefault(name, (path, node.lineno))

    # strict doc claims live in metric TABLES (header row contains
    # "metric"); backticked dotted names in prose are soft coverage —
    # they satisfy the emitted→documented direction but a prose
    # mention of `bench.py` or a trace-zone name is not a claim that
    # a registry metric exists.
    obs = os.path.join(repo_root, "docs", "OBSERVABILITY.md")
    documented: Dict[str, Tuple[str, int]] = {}
    soft_doc: Dict[str, Tuple[str, int]] = {}
    if os.path.isfile(obs):
        with open(obs, encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        in_metric_table = False
        for i, line in enumerate(lines, 1):
            stripped = line.lstrip()
            name_cell = ""
            if stripped.startswith("|"):
                prev = lines[i - 2].lstrip() if i >= 2 else ""
                if not prev.startswith("|"):
                    in_metric_table = "metric" in stripped.lower()
                    continue
                if in_metric_table:
                    # the metric NAME is the first cell; description
                    # cells mention related dotted identifiers freely
                    name_cell = stripped.strip("|").split("|")[0]
            else:
                in_metric_table = False
            cell_names = set(_BACKTICK_DOTTED.findall(name_cell))
            for m in _BACKTICK_DOTTED.finditer(line):
                strict = in_metric_table and m.group(1) in cell_names
                target = documented if strict else soft_doc
                for name in _norm_doc_metric(m.group(1)):
                    target.setdefault(name, (obs, i))

    findings = []
    all_doc = {**soft_doc, **documented}
    for name, (path, line) in sorted(emitted.items()):
        if any(_metric_match(name, d) for d in all_doc):
            continue
        findings.append(Finding(
            pass_name="registry", key=f"metric:{name}",
            path=path, lineno=line,
            message=f"metric {name!r} is emitted here but not "
                    "documented in docs/OBSERVABILITY.md",
            hint="add it to the metrics tables in OBSERVABILITY.md "
                 f"(or allowlist 'metric:{name}' with why not)"))
    for name, (path, line) in sorted(documented.items()):
        if any(_metric_match(name, e) for e in emitted):
            continue
        findings.append(Finding(
            pass_name="registry", key=f"metricdoc:{name}",
            path=path, lineno=line,
            message=f"docs/OBSERVABILITY.md documents metric {name!r} "
                    "but nothing emits it",
            hint="remove the stale doc row or fix the emission name — "
                 "a documented metric that never appears misleads "
                 "operators"))
    return findings


# ----------------------------------------------------------------- knobs --

def _config_knobs(index: PackageIndex) -> Dict[str, Tuple[str, int]]:
    knobs: Dict[str, Tuple[str, int]] = {}
    for mod, tree in index.module_trees.items():
        if not (mod == "main.config" or mod.endswith(".main.config")):
            continue
        path = index.modules[mod]
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and node.name == "Config":
                for item in node.body:
                    if isinstance(item, ast.FunctionDef) and \
                            item.name == "__init__":
                        for sub in ast.walk(item):
                            targets = []
                            if isinstance(sub, ast.Assign):
                                targets = sub.targets
                            elif isinstance(sub, ast.AnnAssign):
                                targets = [sub.target]
                            for t in targets:
                                if isinstance(t, ast.Attribute) and \
                                        isinstance(t.value, ast.Name) \
                                        and t.value.id == "self" and \
                                        _SELF_KNOB.match(t.attr):
                                    knobs.setdefault(
                                        t.attr, (path, sub.lineno))
    return knobs


def _doc_knobs(repo_root: str) -> Dict[str, Tuple[str, int]]:
    """Backticked UPPER_SNAKE names in markdown *knob tables* under
    docs/ — a table whose header row mentions "knob". Prose mentions
    and non-knob tables (chaos kinds, env vars) are not entries."""
    out: Dict[str, Tuple[str, int]] = {}
    for path in sorted(glob.glob(os.path.join(repo_root, "docs",
                                              "*.md"))):
        with open(path, encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        in_knob_table = False
        for i, line in enumerate(lines, 1):
            stripped = line.lstrip()
            if not stripped.startswith("|"):
                in_knob_table = False
                continue
            prev = lines[i - 2].lstrip() if i >= 2 else ""
            if not prev.startswith("|"):
                # header row of a fresh table
                in_knob_table = "knob" in stripped.lower()
                continue
            if in_knob_table:
                # knob name = first cell; description cells mention
                # other UPPER_SNAKE identifiers (states, env vars)
                first = stripped.strip("|").split("|")[0]
                for m in _KNOB_RE.finditer(first):
                    out.setdefault(m.group(1), (path, i))
    return out


def _check_knobs(index: PackageIndex, repo_root: str) -> List[Finding]:
    knobs = _config_knobs(index)
    doc = _doc_knobs(repo_root)
    findings = []
    for name, (path, line) in sorted(knobs.items()):
        if name in doc:
            continue
        findings.append(Finding(
            pass_name="registry", key=f"knob:{name}",
            path=path, lineno=line,
            message=f"config knob {name} has no row in any docs/ "
                    "knob table",
            hint="add it to the table in docs/CONFIG.md (or allowlist "
                 f"'knob:{name}' with why it is intentionally "
                 "undocumented)"))
    for name, (path, line) in sorted(doc.items()):
        if name in knobs:
            continue
        findings.append(Finding(
            pass_name="registry", key=f"knobdoc:{name}",
            path=path, lineno=line,
            message=f"docs table references config knob {name} which "
                    "main/config.py does not define",
            hint="fix the name or drop the stale row — operators "
                 "setting it get a silent no-op"))
    return findings
