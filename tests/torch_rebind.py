"""Shared by tests/test_torch_{xdr_leaves,wasm,persistence,scp,herder}.py:
the JAX package's own tests run a second time on the port, with every
name they import from the JAX package rebound to the port's module of the
same path and imports inside their function bodies redirected there; the
classes they define are rebuilt over the rebound globals, on the port's
bases. The helpers they take from the reference test modules in
HELPER_MODULES run on the port too, in those modules' own rebound
globals. A name whose port module does not exist yet binds to an
`Unported` stand-in, which raises NotImplementedError when it is used,
not when it is rebound."""

from __future__ import annotations

import ast
import builtins
import contextlib
import importlib
import inspect
import sys
import types

import pytest

JAX_ROOT, PORT_ROOT = "stellar_core_tpu", "stellar_core_tpu_torch"
# reference test modules whose helpers other reference tests import
HELPER_MODULES = ("txtest_utils", "test_bucket", "test_ledger_close",
                  "test_ledger_txn", "test_standalone_app", "test_overlay",
                  "test_flow_control_edges", "test_history_catchup")
# the reference's scripts/ modules a reference test imports -> the port's
# copy in its scripts subpackage
SCRIPTS = {"replay_report": PORT_ROOT + ".scripts.replay_report",
           "bench_matrix": PORT_ROOT + ".scripts.bench_matrix"}
_HELPERS: dict = {}     # helper module name -> its rebound module


class Unported:
    """Stands in for a JAX-package name whose port module does not exist
    yet: rebinding succeeds, any use raises NotImplementedError."""

    def __init__(self, name: str):
        self._name = name

    def _missing(self, *args, **kwargs):
        raise NotImplementedError(f"{self._name} is not ported yet")

    __call__ = _missing

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        self._missing()


def port_name(name: str) -> str:
    if name == JAX_ROOT or name.startswith(JAX_ROOT + "."):
        return PORT_ROOT + name[len(JAX_ROOT):]
    return name


def _cpu_verifier(*args, **kwargs):
    """The JAX package's TpuBatchVerifier in a rebound test: the port's
    CudaBatchVerifier on the CPU (its plain kernels)."""
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
    return CudaBatchVerifier(*args, device="cpu", **kwargs)


# names a reference test imports from a JAX module whose port module
# calls them otherwise: (port module, name) -> the port's object
RENAMED = {("stellar_core_tpu_torch.ops.verifier", "TpuBatchVerifier"):
           _cpu_verifier}


def port_import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and name in HELPER_MODULES:
        return helper_module(importlib.import_module(name))
    if level == 0 and name in SCRIPTS:
        return importlib.import_module(SCRIPTS[name])
    if level == 0:
        name = port_name(name)
    out = builtins.__import__(name, globals, locals, fromlist, level)
    renamed = {a: RENAMED[(name, a)] for a in fromlist or ()
               if (name, a) in RENAMED}
    if renamed:
        out = types.SimpleNamespace(**vars(out), **renamed)
    return out


def _port_module(name: str):
    """The port's module of the JAX module `name`, or None."""
    try:
        return importlib.import_module(port_name(name))
    except ModuleNotFoundError:
        return None


def _port_value(name, v):
    """The port's object for a name a reference test module imported from
    the JAX package or from a helper module; anything else unchanged."""
    if isinstance(v, types.ModuleType):
        if v.__name__ in HELPER_MODULES:
            return helper_module(v)
        if v.__name__ in SCRIPTS:
            return importlib.import_module(SCRIPTS[v.__name__])
        if not v.__name__.startswith(JAX_ROOT + "."):
            return v
        return _port_module(v.__name__) or Unported(v.__name__)
    mod = getattr(v, "__module__", None)
    if mod in HELPER_MODULES and isinstance(v, (types.FunctionType, type)):
        return getattr(helper_module(sys.modules[mod]), v.__name__)
    if isinstance(mod, str) and mod.startswith(JAX_ROOT + "."):
        attr = getattr(v, "__name__", name)
        out = getattr(_port_module(mod), attr, None)
        return Unported(f"{mod}.{attr}") if out is None else out
    return v


def _rebind_into(module, g):
    g.update((k, v if getattr(v, "__module__", None) == module.__name__
              else _port_value(k, v)) for k, v in vars(module).items())
    g["__builtins__"] = dict(vars(builtins), __import__=port_import)
    for k, v in vars(module).items():        # the module's own helpers
        if getattr(v, "__module__", None) != module.__name__:
            continue
        if isinstance(v, types.FunctionType):
            g[k] = port_function(v, g)
        elif isinstance(v, type):           # in definition order
            g[k] = port_class(v, g)
    return g


def rebound(module):
    """The module's globals with every JAX-package name replaced by the
    port's, and imports inside function bodies redirected to the port."""
    return _rebind_into(module, {})


def helper_module(module):
    """A module object holding the helper module's rebound globals, its
    own classes rebuilt over them; one per helper (filled after it is
    registered, so helpers that import each other share them)."""
    out = _HELPERS.get(module.__name__)
    if out is None:
        out = _HELPERS[module.__name__] = types.ModuleType(module.__name__)
        _rebind_into(module, vars(out))
    return out


def port_function(fn, g, class_cell=None):
    """`fn` over the globals `g`; with `class_cell`, the cell its
    zero-argument super() reads (`__class__`) is that one."""
    closure = fn.__closure__
    if class_cell is not None and "__class__" in fn.__code__.co_freevars:
        closure = tuple(class_cell if name == "__class__" else c
                        for name, c in zip(fn.__code__.co_freevars, closure))
    out = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                             closure)
    out.__kwdefaults__ = fn.__kwdefaults__
    return out


def port_class(cls, g):
    """`cls`, a class of a reference test module, rebuilt over the globals
    `g`: its functions (also under staticmethod, classmethod and
    property) run there, super() finds the new class, and each base is
    the port's (a base of the same module: its rebuilt class in `g`)."""
    cell = types.CellType()

    def port(f):
        if isinstance(f, types.FunctionType):
            return port_function(f, g, cell)
        if isinstance(f, (staticmethod, classmethod)):
            return type(f)(port(f.__func__))
        if isinstance(f, property):
            return property(*(x and port(x) for x in
                              (f.fget, f.fset, f.fdel)), f.__doc__)
        return f
    bases = tuple(g[b.__name__] if b.__module__ == cls.__module__
                  else _port_value(b.__name__, b) for b in cls.__bases__)
    out = type(cls)(cls.__name__, bases, {
        a: port(f) for a, f in vars(cls).items()
        if a not in ("__dict__", "__weakref__")})
    cell.cell_contents = out
    return out


def port_case(module, owner, name):
    """The reference test `owner.name` (or the module function `name`) as
    a callable running on the port, in the module's `rebound` globals;
    the class's other attributes are the port's objects too."""
    g = rebound(module)
    if owner is None:
        return port_function(getattr(module, name), g)
    cls = getattr(module, owner)
    ported = type(owner, (), {
        k: port_function(f, g) if isinstance(f, types.FunctionType)
        else _port_attribute(k, f)
        for k, f in vars(cls).items() if not k.startswith("__")})
    return getattr(ported(), name)


def _port_attribute(name, v):
    """A class attribute of a reference test class on the port: a list
    or tuple element by element (the types a test iterates over)."""
    if isinstance(v, (list, tuple)):
        return type(v)(_port_value(name, x) for x in v)
    return _port_value(name, v)


def jax_case(module, owner, name):
    return getattr(module, name) if owner is None \
        else getattr(getattr(module, owner)(), name)


def _parameter_sets(fn):
    """The keyword arguments of each case of a test function: one per
    combination of the parameter sets of its `parametrize` marks."""
    params = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        argnames, argvalues = mark.args[:2]
        if isinstance(argnames, str):
            argnames = [a.strip() for a in argnames.split(",")]
        params = [{**p, **dict(zip(argnames, v if len(argnames) > 1
                                    else (v,)))}
                  for p in params for v in argvalues]
    return params


def reference_cases(module, skip=()):
    """Each case of `module`'s tests as a `pytest.param` of (module,
    owner, name, keyword arguments): the methods of its Test* classes
    (owner the class name) and its test functions (owner None), one per
    parameter set of their `parametrize` marks, leaving out the names in
    `skip`. The id is module.owner.name, with [i] for the i-th parameter
    set where there are several."""
    tests = [(owner, n, f) for owner, cls in vars(module).items()
             if owner.startswith("Test") and isinstance(cls, type)
             for n, f in vars(cls).items() if n.startswith("test_")]
    tests += [(None, n, f) for n, f in vars(module).items()
              if n.startswith("test_") and isinstance(f, types.FunctionType)]
    out = []
    for owner, name, fn in tests:
        if name in skip:
            continue
        base = f"{module.__name__}.{owner + '.' if owner else ''}{name}"
        params = _parameter_sets(fn)
        out += [pytest.param((module, owner, name, kw),
                             id=f"{base}[{i}]" if len(params) > 1 else base)
                for i, kw in enumerate(params)]
    return out


def _module_fixtures(module):
    """The pytest fixtures a reference test module defines, by name."""
    out = {}
    for n, obj in vars(module).items():
        marker = getattr(obj, "_fixture_function_marker", None)
        if marker is not None:
            out[marker.name or n] = obj
    return out


def run_case(case, port, builtin):
    """Run the reference case `case` (reference_cases' values) on the JAX
    package, or rebound to the port with `port`. Its arguments are its
    parameters, the fixtures its module defines (rebound with the test
    for the port; a generator fixture's teardown runs after the test),
    the module's autouse fixtures, and the values in `builtin` (pytest's
    own fixtures, such as tmp_path, made for this run). Returns what the
    test returns."""
    module, owner, name, kw = case
    fn = (port_case if port else jax_case)(module, owner, name)
    fixtures = _module_fixtures(module)
    g = rebound(module) if port else None
    with contextlib.ExitStack() as stack:
        made = {}

        def value(n):
            if n in made:
                return made[n]
            if n in builtin:
                v = builtin[n]
            else:
                f = fixtures[n].__wrapped__
                if port:
                    f = port_function(f, g)
                v = f(**{p: value(p)
                         for p in inspect.signature(f).parameters})
                if inspect.isgenerator(v):
                    gen, v = v, next(v)
                    stack.callback(next, gen, None)
            made[n] = v
            return v
        for n, f in fixtures.items():
            if f._fixture_function_marker.autouse:
                value(n)
        return fn(**{p: kw[p] if p in kw else value(p)
                     for p in inspect.signature(fn).parameters})


def module_code(path, swap=False):
    """The module at `path` as an AST dump without its docstrings
    (comments never reach it), the JAX package's name swapped for the
    port's with `swap`: what the tests that hold a copied module equal
    to the reference's compare."""
    text = path.read_text()
    if swap:
        text = text.replace(JAX_ROOT, PORT_ROOT)
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)
