"""Pass 2 — thread-domain propagation and cross-domain write check.

Entry points declare their domain (``# thread-domain: <name>`` on the
``def`` line, or a ``@threads.entry("<name>")`` decorator); the pass
propagates domains through the typed call graph:

- ``call`` edges: the caller's domains flow into the callee — a
  function called from both an HTTP handler and crank code runs in
  {http, crank}.
- ``post`` edges (``clock.post(cb)`` / ``VirtualTimer.async_wait`` /
  ``schedule_at``): the callback lands back on the crank loop, so it
  gets {crank} regardless of who scheduled it — this is exactly why
  routing work through post() makes it safe.
- ``spawn`` edges (``threading.Thread(target=f)``,
  ``CloseCompletionQueue.submit``): the target runs on its own worker
  thread — it gets its declared domain, or a generated
  ``thread:<name>`` domain when undeclared.

Functions never touched by propagation default to {crank} (the single
logical main thread), and crank flows onward through their calls.

The check: every attribute key (``Class.attr``) written from two or
more domains where at least one write is *unprotected* — not under a
lock-ish ``with`` (name matching lock/cond/mutex/sem) and not in
``__init__`` — is a finding. This is the bug class of admin HTTP
commands racing the crank loop's drain swap, caught at analysis time.

Allowlist keys: ``domain:<module>:<Class.attr>``.
"""

from __future__ import annotations

from typing import Dict, List, Set

from .astgraph import CALL, POST, SPAWN, Finding, PackageIndex

CRANK = "crank"

_HINT = ("route the write through clock.post(...) so it runs on the "
         "crank loop, hold the owning lock at every write site, or "
         "allowlist with a justification if the attribute is "
         "genuinely single-writer")


def propagate(index: PackageIndex) -> Dict[str, Set[str]]:
    """Fixpoint domain sets per function key."""
    domains: Dict[str, Set[str]] = {k: set() for k in index.funcs}

    # seed: declarations + spawn targets
    for key, fn in index.funcs.items():
        if fn.declared_domain:
            domains[key].add(fn.declared_domain)
        for edge in fn.calls:
            if edge.kind == SPAWN:
                for t in edge.targets:
                    tfn = index.funcs.get(t)
                    if tfn is None:
                        continue
                    domains[t].add(tfn.declared_domain
                                   or f"thread:{tfn.name}")

    def flow() -> None:
        changed = True
        while changed:
            changed = False
            for key, fn in index.funcs.items():
                src = domains[key]
                for edge in fn.calls:
                    if edge.kind == CALL:
                        add = src
                    elif edge.kind == POST:
                        add = {CRANK}
                    else:
                        continue
                    if not add:
                        continue
                    for t in edge.targets:
                        if t in domains and not add <= domains[t]:
                            domains[t] |= add
                            changed = True

    flow()
    # untouched functions run on the main logical thread; crank then
    # flows onward through their call edges
    for key in domains:
        if not domains[key]:
            domains[key].add(CRANK)
    flow()
    return domains


def run(index: PackageIndex) -> List[Finding]:
    domains = propagate(index)

    # group attribute writes by (module, Class.attr)
    writes: Dict[tuple, list] = {}
    for key, fn in index.funcs.items():
        for w in fn.writes:
            writes.setdefault((fn.module, w.attr_key), []).append(
                (key, w))

    findings: List[Finding] = []
    for (mod, attr_key), sites in sorted(writes.items()):
        touched: Set[str] = set()
        for fkey, _w in sites:
            touched |= domains[fkey]
        if len(touched) < 2:
            continue
        unprotected = [(fkey, w) for fkey, w in sites if not w.protected]
        if not unprotected:
            continue
        fkey, w = unprotected[0]
        fn = index.funcs[fkey]
        by_site = ", ".join(
            f"{index.funcs[fk].qualname}:{ww.lineno}"
            f"[{'/'.join(sorted(domains[fk]))}"
            f"{'' if ww.protected else ' UNPROTECTED'}]"
            for fk, ww in sites)
        findings.append(Finding(
            pass_name="domains",
            key=f"domain:{mod}:{attr_key}",
            path=fn.path, lineno=w.lineno,
            message=f"{attr_key} written from domains "
                    f"{sorted(touched)} with unprotected write in "
                    f"{fn.qualname} (via {w.via}); sites: {by_site}",
            hint=_HINT))
    return findings
