"""Shared by tests/test_torch_{xdr_leaves,wasm}.py: the JAX package's own
tests run a second time on the port, with every name they import from the
JAX package rebound to the port's module of the same path and imports
inside their function bodies redirected there."""

from __future__ import annotations

import builtins
import importlib
import types

import pytest

JAX_ROOT, PORT_ROOT = "stellar_core_tpu", "stellar_core_tpu_torch"


def port_name(name: str) -> str:
    if name == JAX_ROOT or name.startswith(JAX_ROOT + "."):
        return PORT_ROOT + name[len(JAX_ROOT):]
    return name


def port_import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0:
        name = port_name(name)
    return builtins.__import__(name, globals, locals, fromlist, level)


def _port_value(name, v):
    """The port's object for a name a reference test module imported from
    the JAX package; anything else unchanged."""
    if isinstance(v, types.ModuleType):
        return importlib.import_module(port_name(v.__name__)) \
            if v.__name__.startswith(JAX_ROOT + ".") else v
    mod = getattr(v, "__module__", None)
    if isinstance(mod, str) and mod.startswith(JAX_ROOT + "."):
        return getattr(importlib.import_module(port_name(mod)),
                       getattr(v, "__name__", name))
    return v


def rebound(module):
    """The module's globals with every JAX-package name replaced by the
    port's, and imports inside function bodies redirected to the port."""
    g = {k: _port_value(k, v) for k, v in vars(module).items()}
    g["__builtins__"] = dict(vars(builtins), __import__=port_import)
    for k, v in vars(module).items():        # the module's own helpers
        if isinstance(v, types.FunctionType) and \
                v.__module__ == module.__name__:
            g[k] = port_function(v, g)
    return g


def port_function(fn, g):
    return types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                              fn.__closure__)


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
