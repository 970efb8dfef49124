"""Shared by tests/test_torch_{xdr_leaves,wasm,persistence}.py: the JAX
package's own tests run a second time on the port, with every name they
import from the JAX package rebound to the port's module of the same path
and imports inside their function bodies redirected there. The helpers
they take from the reference test modules in HELPER_MODULES run on the
port too, in those modules' own rebound globals. A name whose port module
does not exist yet binds to an `Unported` stand-in, which raises
NotImplementedError when it is used, not when it is rebound."""

from __future__ import annotations

import builtins
import importlib
import sys
import types

import pytest

JAX_ROOT, PORT_ROOT = "stellar_core_tpu", "stellar_core_tpu_torch"
# reference test modules whose helpers other reference tests import
HELPER_MODULES = ("txtest_utils", "test_bucket", "test_ledger_close",
                  "test_ledger_txn")
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


def port_import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and name in HELPER_MODULES:
        return helper_module(importlib.import_module(name))
    if level == 0:
        name = port_name(name)
    return builtins.__import__(name, globals, locals, fromlist, level)


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
        if isinstance(v, types.FunctionType) and \
                v.__module__ == module.__name__:
            g[k] = port_function(v, g)
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
        g = _rebind_into(module, vars(out))
        for k, v in vars(module).items():
            if isinstance(v, type) and v.__module__ == module.__name__:
                g[k] = type(k, v.__bases__, {
                    a: port_function(f, g)
                    if isinstance(f, types.FunctionType) else f
                    for a, f in vars(v).items()
                    if a not in ("__dict__", "__weakref__")})
    return out


def port_function(fn, g):
    out = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                             fn.__closure__)
    out.__kwdefaults__ = fn.__kwdefaults__
    return out


def port_case(module, owner, name):
    """The reference test `owner.name` (or the module function `name`) as
    a callable running on the port, in the module's `rebound` globals."""
    g = rebound(module)
    if owner is None:
        return port_function(getattr(module, name), g)
    cls = getattr(module, owner)
    ported = type(owner, (), {
        k: port_function(f, g) for k, f in vars(cls).items()
        if isinstance(f, types.FunctionType)})
    return getattr(ported(), name)


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
