"""XDR schema identity and the protocol-curr / protocol-next split.

Reference mechanisms being reproduced:
  - `src/protocol-curr/` vs `src/protocol-next/`: two complete XDR type
    trees built side by side so a *structural* next-protocol change is
    representable before it activates (Makefile.am:46-51).
  - XDR identity hashing: the reference hashes its .x definitions into
    the binary and cross-checks them against the Rust host's XDR
    (Makefile.am:28-32, rust/src/lib.rs:631) so two builds can prove
    they speak the same wire language.

This build's types are declarative Python classes, so a "type set" is a
NAMESPACE {name: class}.  `curr_namespace()` collects every XDR type
the node registered at import; `next_namespace()` overlays the
structural deltas declared in `next_types.py`.  `schema_hash()` renders
a canonical descriptor of every type (fields, arm tables, enum values —
the wire-relevant structure, nothing else) and hashes it; equal hashes
⟺ identical wire language.  The node reports both hashes in `info` /
`version` so operators can compare builds the way the reference
compares its embedded .x hashes.
"""

from __future__ import annotations

import hashlib
from enum import IntEnum
from typing import Dict

from . import runtime as rt


def _type_name(ft) -> str:
    """Canonical name for a field-type descriptor — structure only."""
    if isinstance(ft, rt.Opaque):
        return f"opaque[{ft.n}]"
    if isinstance(ft, rt.XdrString):
        return f"string<{ft.max_len}>"
    if isinstance(ft, rt.VarOpaque):
        return f"opaque<{ft.max_len}>"
    if isinstance(ft, rt.Array):
        return f"{_type_name(ft.elem)}[{ft.n}]"
    if isinstance(ft, rt.VarArray):
        return f"{_type_name(ft.elem)}<{ft.max_len}>"
    if isinstance(ft, rt.Optional):
        return f"*{_type_name(ft.elem)}"
    if isinstance(ft, rt.Lazy):
        return _type_name(ft._get())
    if isinstance(ft, rt.EnumType):
        return ft.enum_cls.__name__
    if isinstance(ft, rt._Composite):
        return ft.cls.__name__
    for name, singleton in (("int32", rt.Int32), ("uint32", rt.Uint32),
                            ("int64", rt.Int64), ("uint64", rt.Uint64),
                            ("bool", rt.Bool)):
        if ft is singleton:
            return name
    return type(ft).__name__


def describe_type(cls) -> str:
    """One-line canonical descriptor of a Struct/Union/IntEnum."""
    if isinstance(cls, type) and issubclass(cls, IntEnum):
        vals = ",".join(f"{m.name}={m.value}" for m in cls)
        return f"enum {cls.__name__} {{{vals}}}"
    if isinstance(cls, type) and issubclass(cls, rt.Struct):
        fields = ",".join(f"{fn}:{_type_name(ft)}"
                          for fn, ft in cls._FIELDS)
        return f"struct {cls.__name__} {{{fields}}}"
    if isinstance(cls, type) and issubclass(cls, rt.Union):
        sw = _type_name(cls._SWITCH)
        arms = []
        for disc in sorted(cls._ARMS, key=lambda d: int(d)):
            arm = cls._ARMS[disc]
            if arm is None:
                arms.append(f"{int(disc)}:void")
            else:
                an, at = arm
                arms.append(f"{int(disc)}:{an}:"
                            f"{_type_name(at) if at else 'void'}")
        d = cls._DEFAULT_ARM
        if d != "_missing_":
            if d is None:
                arms.append("default:void")
            else:
                arms.append(f"default:{d[0]}:"
                            f"{_type_name(d[1]) if d[1] else 'void'}")
        return f"union {cls.__name__} switch({sw}) {{{','.join(arms)}}}"
    raise TypeError(f"not an XDR type: {cls!r}")


_XDR_MODULES = ("types", "ledger_entries", "ledger", "transaction",
                "results", "scp", "overlay", "contract")


def curr_namespace() -> Dict[str, type]:
    """Every XDR type of the current-protocol build."""
    import importlib
    ns: Dict[str, type] = {}
    for mod_name in _XDR_MODULES:
        mod = importlib.import_module(f"{__package__}.{mod_name}")
        for name, obj in vars(mod).items():
            if not isinstance(obj, type):
                continue
            if issubclass(obj, (rt.Struct, rt.Union)) and \
                    obj not in (rt.Struct, rt.Union):
                ns.setdefault(name, obj)
            elif issubclass(obj, IntEnum) and obj is not IntEnum:
                ns.setdefault(name, obj)
    return ns


def next_namespace() -> Dict[str, type]:
    """The protocol-next type set: curr overlaid with the structural
    deltas (next_types.NEXT_TYPES)."""
    from . import next_types
    ns = dict(curr_namespace())
    ns.update(next_types.NEXT_TYPES)
    return ns


def schema_hash(ns: Dict[str, type]) -> bytes:
    lines = sorted(describe_type(cls) for cls in set(ns.values()))
    h = hashlib.sha256()
    for line in lines:
        h.update(line.encode())
        h.update(b"\n")
    return h.digest()


def identity() -> Dict[str, str]:
    """Both builds' schema hashes (the `info`/`version` surface)."""
    return {"curr": schema_hash(curr_namespace()).hex(),
            "next": schema_hash(next_namespace()).hex()}
