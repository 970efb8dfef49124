"""Package index + name-based call graph for the analysis passes.

One parse of every ``.py`` under the package root builds:

- a per-module import table (aliases resolved to canonical dotted
  names, relative imports resolved against the package);
- a ``FuncInfo`` per function/method (incl. nested defs and lambdas
  handed to ``post``-like schedulers), carrying its call edges,
  nondeterminism occurrences, attribute writes, and declared thread
  domain;
- global name tables the resolver uses for CHA-style resolution:
  ``self.foo()`` binds to the enclosing class's ``foo`` when it has
  one, otherwise (and for ``obj.foo()``) to every package method named
  ``foo`` — deliberately over-approximate, because a missed edge is a
  silently-missed finding while a spurious edge costs one allowlist
  review. A stoplist of builtin-collection method names keeps the
  over-approximation from smearing the graph through ``.append`` /
  ``.get`` / ``.items``.

Edges are typed, because the thread-domain pass treats them
differently: ``call`` propagates the caller's domains, ``post``
reroutes the callback to the crank domain (that is the whole point of
``clock.post``), and ``spawn`` seeds the target with its own declared
worker domain.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

# ---------------------------------------------------------------- model --

CALL = "call"      # plain call: caller's domains flow into callee
POST = "post"      # callback scheduled onto the crank loop
SPAWN = "spawn"    # callback runs on its own worker thread

# attr-call names never resolved globally (builtin collection/IO noise);
# self.X() still resolves within the class
_GENERIC_METHODS = frozenset((
    "get", "set", "put", "add", "pop", "popleft", "append", "appendleft",
    "extend", "clear", "update", "remove", "discard", "insert", "keys",
    "values", "items", "copy", "join", "split", "rsplit", "strip",
    "read", "write", "open", "close", "encode", "decode", "wait",
    "notify", "notify_all", "acquire", "release", "start", "stop",
    "run", "send", "recv", "connect", "accept", "flush", "sort",
    "count", "index", "format", "match", "search", "group", "exists",
    "mkdir", "load", "loads", "dump", "dumps", "hexdigest", "digest",
    "info", "debug", "warning", "error", "exception", "result",
    "cancel", "done", "is_set", "setdefault", "total_seconds", "lower",
    "upper", "startswith", "endswith", "to_bytes", "from_bytes",
))

# cross-object calls resolve only when the name is this selective
_MAX_GLOBAL_CANDIDATES = 8

# receiver-method mutators: self.X.append(...) is a write to self.X
_MUTATORS = frozenset((
    "append", "appendleft", "extend", "pop", "popleft", "clear",
    "update", "add", "remove", "discard", "insert", "setdefault",
    "push", "put",
))

_LOCKISH = re.compile(r"(lock|cond|mutex|sem)", re.IGNORECASE)
_DOMAIN_COMMENT = re.compile(r"#\s*thread-domain:\s*([A-Za-z0-9_-]+)")


@dataclass
class Occurrence:
    """One nondeterminism source occurrence inside a function body."""
    kind: str        # wallclock | monotonic | sleep | random | set-iter
    source: str      # canonical dotted name, e.g. time.time
    lineno: int


@dataclass
class AttrWrite:
    attr_key: str    # "Class.attr"
    lineno: int
    protected: bool  # lexically under a lock-ish `with`, or in __init__
    via: str         # assign | augassign | subscript | mutator:<name>


@dataclass
class CallEdge:
    kind: str                 # CALL | POST | SPAWN
    targets: Set[str]         # resolved FuncInfo keys
    text: str                 # source-ish callee text for evidence
    lineno: int


@dataclass
class FuncInfo:
    key: str                  # "module:qualname" (module pkg-relative)
    module: str               # pkg-relative dotted module, e.g. util.timer
    qualname: str             # "Class.method" / "func" / "outer.inner"
    name: str
    class_name: Optional[str]
    path: str
    lineno: int
    declared_domain: Optional[str] = None
    calls: List[CallEdge] = field(default_factory=list)
    nondet: List[Occurrence] = field(default_factory=list)
    writes: List[AttrWrite] = field(default_factory=list)


@dataclass
class Finding:
    pass_name: str   # determinism | domains | registry | allowlist
    key: str         # stable allowlist key
    path: str
    lineno: int
    message: str
    hint: str
    chain: List[str] = field(default_factory=list)

    def to_json(self) -> dict:
        return {"pass": self.pass_name, "key": self.key,
                "path": self.path, "line": self.lineno,
                "message": self.message, "hint": self.hint,
                "chain": self.chain}

    def render(self) -> str:
        loc = f"{self.path}:{self.lineno}"
        out = f"[{self.pass_name}] {loc}: {self.message}\n    hint: {self.hint}"
        if self.chain:
            out += "\n    via:  " + " -> ".join(self.chain)
        return out


class PackageIndex:
    def __init__(self, pkg_root: str, pkg_name: str):
        self.pkg_root = pkg_root
        self.pkg_name = pkg_name
        self.modules: Dict[str, str] = {}            # rel module -> path
        self.module_trees: Dict[str, ast.Module] = {}
        self.module_sources: Dict[str, List[str]] = {}
        self.funcs: Dict[str, FuncInfo] = {}
        self.funcs_by_name: Dict[str, Set[str]] = {}
        self.class_methods: Dict[Tuple[str, str], Set[str]] = {}
        self.classes: Dict[str, Set[str]] = {}       # class name -> modules

    # -- lookups used by the passes -------------------------------------
    def find_func(self, module_suffix: str, qualname: str) -> Optional[str]:
        for key, fn in self.funcs.items():
            if fn.qualname == qualname and (
                    fn.module == module_suffix
                    or fn.module.endswith("." + module_suffix)):
                return key
        return None

    def reachable_from(self, roots: List[str],
                       kinds: Tuple[str, ...] = (CALL, POST, SPAWN),
                       ) -> Dict[str, Optional[str]]:
        """BFS over typed edges; returns {key: parent_key} for the
        evidence chain (roots map to None)."""
        parents: Dict[str, Optional[str]] = {}
        frontier = []
        for r in roots:
            if r in self.funcs and r not in parents:
                parents[r] = None
                frontier.append(r)
        while frontier:
            cur = frontier.pop()
            for edge in self.funcs[cur].calls:
                if edge.kind not in kinds:
                    continue
                for t in edge.targets:
                    if t in self.funcs and t not in parents:
                        parents[t] = cur
                        frontier.append(t)
        return parents

    def chain(self, parents: Dict[str, Optional[str]], key: str,
              ) -> List[str]:
        out = []
        cur: Optional[str] = key
        seen = set()
        while cur is not None and cur not in seen:
            seen.add(cur)
            fn = self.funcs[cur]
            out.append(f"{fn.module}.{fn.qualname}")
            cur = parents.get(cur)
        return list(reversed(out))


# ------------------------------------------------------------- building --

def build_index(pkg_root: str) -> PackageIndex:
    pkg_name = os.path.basename(os.path.normpath(pkg_root))
    index = PackageIndex(pkg_root, pkg_name)
    for base, _dirs, files in os.walk(pkg_root):
        _dirs[:] = [d for d in _dirs if d != "__pycache__"]
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(base, f)
            rel = os.path.relpath(path, pkg_root)
            mod = rel[:-3].replace(os.sep, ".")
            if mod.endswith(".__init__"):
                mod = mod[: -len(".__init__")] or "__init__"
            with open(path, encoding="utf-8") as fh:
                src = fh.read()
            try:
                tree = ast.parse(src, filename=path)
            except SyntaxError as e:
                raise RuntimeError(f"analysis parse failure {path}: {e}")
            index.modules[mod] = path
            index.module_trees[mod] = tree
            index.module_sources[mod] = src.splitlines()
    for mod in index.modules:
        _index_module(index, mod)
    return index


def _index_module(index: PackageIndex, mod: str) -> None:
    tree = index.module_trees[mod]
    path = index.modules[mod]
    imports = _import_table(index, mod, tree)
    # first sweep: register every def so the resolver sees the whole
    # module before edges are extracted
    visitor = _ModuleVisitor(index, mod, path, imports)
    visitor.register(tree)
    visitor.extract(tree)


def _import_table(index: PackageIndex, mod: str,
                  tree: ast.Module) -> Dict[str, str]:
    """alias -> canonical dotted name (module or module.symbol)."""
    table: Dict[str, str] = {}
    pkg_parts = mod.split(".")[:-1] if mod != "__init__" else []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    table[a.asname] = a.name
                else:
                    head = a.name.split(".")[0]
                    table[head] = head
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base_parts = pkg_parts[: len(pkg_parts) - (node.level - 1)] \
                    if node.level > 1 else list(pkg_parts)
                base = ".".join(base_parts)
                src = base + ("." + node.module if node.module else "")
                src = src.strip(".")
            else:
                src = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                table[a.asname or a.name] = (src + "." + a.name) \
                    if src else a.name
    return table


class _ModuleVisitor:
    def __init__(self, index: PackageIndex, mod: str, path: str,
                 imports: Dict[str, str]):
        self.index = index
        self.mod = mod
        self.path = path
        self.imports = imports
        self.src_lines = index.module_sources[mod]
        self.local_funcs: Dict[str, str] = {}   # plain name -> key
        self.local_classes: Set[str] = set()

    # -- pass A: register defs ------------------------------------------
    def register(self, tree: ast.Module) -> None:
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._register_func(node, qual=node.name, cls=None)
            elif isinstance(node, ast.ClassDef):
                self.local_classes.add(node.name)
                self.index.classes.setdefault(node.name, set()).add(self.mod)
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._register_func(
                            item, qual=f"{node.name}.{item.name}",
                            cls=node.name)

    def _register_func(self, node, qual: str, cls: Optional[str]) -> str:
        key = f"{self.mod}:{qual}"
        fn = FuncInfo(key=key, module=self.mod, qualname=qual,
                      name=node.name if hasattr(node, "name")
                      else qual.rsplit(".", 1)[-1],
                      class_name=cls, path=self.path, lineno=node.lineno,
                      declared_domain=self._declared_domain(node))
        self.index.funcs[key] = fn
        self.index.funcs_by_name.setdefault(fn.name, set()).add(key)
        if cls:
            self.index.class_methods.setdefault(
                (cls, fn.name), set()).add(key)
        if cls is None:
            self.local_funcs[fn.name] = key
        return key

    def _declared_domain(self, node) -> Optional[str]:
        # decorator form: @threads.entry("http") / @entry("http")
        for dec in getattr(node, "decorator_list", ()):
            if isinstance(dec, ast.Call) and dec.args:
                name = _dotted(dec.func) or ""
                if name.split(".")[-1] in ("entry", "domain") and \
                        isinstance(dec.args[0], ast.Constant) and \
                        isinstance(dec.args[0].value, str):
                    return dec.args[0].value
        # structured comment on the def line or the line above
        for ln in (node.lineno, node.lineno - 1):
            if 1 <= ln <= len(self.src_lines):
                m = _DOMAIN_COMMENT.search(self.src_lines[ln - 1])
                if m:
                    return m.group(1)
        return None

    # -- pass B: extract edges/occurrences/writes -----------------------
    def extract(self, tree: ast.Module) -> None:
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._extract_func(node, qual=node.name, cls=None)
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._extract_func(
                            item, qual=f"{node.name}.{item.name}",
                            cls=node.name)

    def _extract_func(self, node, qual: str, cls: Optional[str]) -> None:
        key = f"{self.mod}:{qual}"
        fn = self.index.funcs.get(key)
        if fn is None:
            return
        body = _BodyVisitor(self, fn, cls)
        for stmt in node.body:
            body.visit(stmt)

    # -- resolution ------------------------------------------------------
    def resolve_callee(self, node: ast.expr,
                       cls: Optional[str]) -> Tuple[Set[str], str]:
        """Resolve a callee expression to FuncInfo keys + display text."""
        text = _dotted(node) or "<dynamic>"
        targets: Set[str] = set()
        if isinstance(node, ast.Name):
            name = node.id
            if name in self.local_funcs:
                targets.add(self.local_funcs[name])
            elif name in self.local_classes:
                targets |= self.index.class_methods.get(
                    (name, "__init__"), set())
            elif name in self.imports:
                targets |= self._resolve_canonical(self.imports[name])
        elif isinstance(node, ast.Attribute):
            attr = node.attr
            canon = self._canonical(text)
            if canon:
                resolved = self._resolve_canonical(canon)
                if resolved:
                    return resolved, text
            recv_is_self = isinstance(node.value, ast.Name) \
                and node.value.id == "self"
            if recv_is_self and cls:
                hit = self.index.class_methods.get((cls, attr), set())
                if hit:
                    return hit, text
            if attr not in _GENERIC_METHODS:
                cands: Set[str] = set()
                for k in self.index.funcs_by_name.get(attr, ()):  # methods+funcs
                    if self.index.funcs[k].class_name is not None \
                            or recv_is_self:
                        cands.add(k)
                if cands and (recv_is_self
                              or len(cands) <= _MAX_GLOBAL_CANDIDATES):
                    targets |= cands
        return targets, text

    def _canonical(self, dotted: Optional[str]) -> Optional[str]:
        """Rewrite the leading alias of a dotted name via the import
        table: `_time.sleep` -> `time.sleep`, `chaos.point` ->
        `<pkg>.util.chaos.point`."""
        if not dotted:
            return None
        head, _, rest = dotted.partition(".")
        if head == "self":
            return None
        base = self.imports.get(head)
        if base is None:
            return None
        return base + ("." + rest if rest else "")

    def _resolve_canonical(self, canon: str) -> Set[str]:
        """Canonical dotted name -> package FuncInfo keys (if it names
        a function/method of an in-package module). Relative imports
        resolve pkg-relative (module names are keyed that way), so both
        `pkg.util.foo.bar` and `util.foo.bar` shapes are accepted —
        stdlib heads like `time.` fall out because they never match a
        module prefix."""
        pkg = self.index.pkg_name + "."
        rel = canon[len(pkg):] if canon.startswith(pkg) else canon
        # longest module prefix that exists, remainder is the qualname
        parts = rel.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:cut])
            if mod in self.index.modules:
                qual = ".".join(parts[cut:])
                key = f"{mod}:{qual}"
                if key in self.index.funcs:
                    return {key}
                # a class: constructor
                init = f"{mod}:{qual}.__init__"
                if init in self.index.funcs:
                    return {init}
                return set()
        return set()


class _BodyVisitor(ast.NodeVisitor):
    """Single-function body walk: edges, nondet occurrences, writes."""

    def __init__(self, owner: _ModuleVisitor, fn: FuncInfo,
                 cls: Optional[str]):
        self.o = owner
        self.fn = fn
        self.cls = cls
        self.with_depth = 0        # inside any lock-ish `with`
        self._nested_seq = 0

    # -- helpers ---------------------------------------------------------
    def _protected(self) -> bool:
        return self.with_depth > 0 or self.fn.name == "__init__"

    def _callback_targets(self, arg: ast.expr) -> Set[str]:
        """Resolve a callback argument (name, self.method, partial,
        lambda, nested def reference) to FuncInfo keys."""
        if isinstance(arg, ast.Lambda):
            return {self._spawn_lambda(arg)}
        if isinstance(arg, ast.Call):
            callee = _dotted(arg.func) or ""
            if callee.split(".")[-1] == "partial" and arg.args:
                return self._callback_targets(arg.args[0])
            return set()
        targets, _ = self.o.resolve_callee(arg, self.cls)
        return targets

    def _spawn_lambda(self, node: ast.Lambda) -> str:
        self._nested_seq += 1
        qual = f"{self.fn.qualname}.<lambda@{node.lineno}>"
        key = f"{self.o.mod}:{qual}"
        sub = FuncInfo(key=key, module=self.o.mod, qualname=qual,
                       name=f"<lambda@{node.lineno}>",
                       class_name=self.cls, path=self.fn.path,
                       lineno=node.lineno)
        self.o.index.funcs[key] = sub
        body = _BodyVisitor(self.o, sub, self.cls)
        body.visit(node.body)
        return key

    def _add_edge(self, kind: str, targets: Set[str], text: str,
                  lineno: int) -> None:
        if targets:
            self.fn.calls.append(CallEdge(kind, targets, text, lineno))

    # -- nested defs: own FuncInfo, CALL edge when referenced -----------
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        qual = f"{self.fn.qualname}.{node.name}"
        key = self.o._register_func(node, qual=qual, cls=self.cls)
        # re-key: nested defs are locally referable by bare name
        self.o.local_funcs.setdefault(node.name, key)
        sub = _BodyVisitor(self.o, self.o.index.funcs[key], self.cls)
        for stmt in node.body:
            sub.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # plain lambda: body runs wherever it is eventually called;
        # keep it attached to the enclosing function via a CALL edge
        key = self._spawn_lambda(node)
        self._add_edge(CALL, {key}, "<lambda>", node.lineno)

    # -- with: lock detection -------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        lockish = any(_LOCKISH.search(_dotted(item.context_expr) or
                                      _dotted(getattr(item.context_expr,
                                                      "func", None)) or "")
                      for item in node.items)
        if lockish:
            self.with_depth += 1
        for item in node.items:
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        if lockish:
            self.with_depth -= 1

    # -- writes ----------------------------------------------------------
    def _record_write(self, target: ast.expr, via: str,
                      lineno: int) -> None:
        # self.attr = / self.attr[k] = / self.attr.append(...)
        node = target
        if isinstance(node, ast.Subscript):
            via = "subscript"
            node = node.value
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self" and self.cls:
            self.fn.writes.append(AttrWrite(
                attr_key=f"{self.cls}.{node.attr}", lineno=lineno,
                protected=self._protected(), via=via))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record_write(t, "assign", node.lineno)
            if isinstance(t, ast.Tuple):
                for elt in t.elts:
                    self._record_write(elt, "assign", node.lineno)
        self.visit(node.value)
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                self.visit(t.value)
                self.visit(t.slice)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_write(node.target, "augassign", node.lineno)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_write(node.target, "assign", node.lineno)
            self.visit(node.value)

    # -- calls: edges, schedulers, threads, nondet ----------------------
    def visit_Call(self, node: ast.Call) -> None:
        text = _dotted(node.func) or "<dynamic>"
        attr = text.split(".")[-1]
        canon = self.o._canonical(text) or text

        # nondeterminism occurrences (canonical names)
        kind_src = _nondet_kind(canon)
        if kind_src:
            self.fn.nondet.append(Occurrence(kind_src[0], kind_src[1],
                                             node.lineno))
        elif canon == "random.Random" and not node.args:
            # seeded Random(seed) is deterministic; bare Random() is not
            self.fn.nondet.append(Occurrence(
                "random", "random.Random(unseeded)", node.lineno))

        # threading.Thread(target=fn) -> SPAWN edge
        if canon in ("threading.Thread", "Thread") or \
                text.endswith("threading.Thread"):
            for kw in node.keywords:
                if kw.arg == "target":
                    self._add_edge(SPAWN, self._callback_targets(kw.value),
                                   text, node.lineno)

        # scheduler reroutes: callbacks land back on the crank loop
        if attr == "post" and node.args:
            self._add_edge(POST, self._callback_targets(node.args[0]),
                           text, node.lineno)
        elif attr == "async_wait":
            for arg in node.args:
                self._add_edge(POST, self._callback_targets(arg),
                               text, node.lineno)
        elif attr == "schedule_at" and len(node.args) >= 2:
            self._add_edge(POST, self._callback_targets(node.args[1]),
                           text, node.lineno)
        elif attr == "submit" and "completion" in text:
            # CloseCompletionQueue.submit(seq, fn): fn runs on the
            # completion worker (docs/ANALYSIS.md documents this seam)
            if len(node.args) >= 2:
                self._add_edge(SPAWN, self._callback_targets(node.args[1]),
                               text, node.lineno)

        # mutating method call on self.attr -> write
        if attr in _MUTATORS and isinstance(node.func, ast.Attribute):
            self._record_write(node.func.value, f"mutator:{attr}",
                               node.lineno)

        # plain call edge
        targets, text2 = self.o.resolve_callee(node.func, self.cls)
        self._add_edge(CALL, targets, text2, node.lineno)

        if isinstance(node.func, ast.Attribute):
            # chained receivers can hold further calls: a.b(x).c(y)
            self.visit(node.func.value)
        for arg in node.args:
            self.visit(arg)
        for kw in node.keywords:
            self.visit(kw.value)

    # -- set iteration ---------------------------------------------------
    def visit_For(self, node: ast.For) -> None:
        if _is_set_expr(node.iter):
            self.fn.nondet.append(Occurrence(
                "set-iter", "iteration over unordered set", node.lineno))
        self.generic_visit(node)

    def visit_comprehension_node(self, node) -> None:
        for gen in node.generators:
            if _is_set_expr(gen.iter):
                self.fn.nondet.append(Occurrence(
                    "set-iter", "iteration over unordered set",
                    node.lineno))
        self.generic_visit(node)

    visit_ListComp = visit_comprehension_node
    visit_SetComp = visit_comprehension_node
    visit_DictComp = visit_comprehension_node
    visit_GeneratorExp = visit_comprehension_node


# ----------------------------------------------------------- utilities --

def _dotted(node) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    if isinstance(node, ast.Call):
        return _dotted(node.func)
    return None


def _is_set_expr(node: ast.expr) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id == "set":
        return True
    return False


# canonical nondeterminism sources -> (kind, canonical-name)
_RANDOM_FNS = frozenset((
    "random", "randint", "randrange", "choice", "choices", "sample",
    "shuffle", "getrandbits", "uniform", "gauss", "normalvariate",
    "betavariate", "expovariate", "randbytes", "triangular",
))


def _nondet_kind(canon: str) -> Optional[Tuple[str, str]]:
    if canon in ("time.time", "time.time_ns"):
        return ("wallclock", canon)
    if canon in ("datetime.now", "datetime.utcnow", "datetime.today",
                 "datetime.datetime.now", "datetime.datetime.utcnow",
                 "datetime.datetime.today"):
        return ("wallclock", canon)
    if canon in ("time.monotonic", "time.monotonic_ns",
                 "time.perf_counter", "time.perf_counter_ns"):
        return ("monotonic", canon)
    if canon == "time.sleep":
        return ("sleep", canon)
    if canon == "os.urandom":
        return ("random", canon)
    parts = canon.split(".")
    if parts[0] == "random" and len(parts) == 2 and \
            parts[1] in _RANDOM_FNS:
        return ("random", canon)
    if parts[0] == "secrets":
        return ("random", canon)
    if canon in ("uuid.uuid1", "uuid.uuid4"):
        return ("random", canon)
    if len(parts) >= 3 and parts[0] in ("np", "numpy") and \
            parts[1] == "random":
        return ("random", "numpy.random." + parts[2])
    return None
