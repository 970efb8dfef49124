"""Type-aware XDR → JSON-able conversion (reference: xdr_to_string /
cereal JSON output used by dump-ledger and print-xdr; union
discriminants render as their enum names, keys as strkey, opaques as
hex)."""

from __future__ import annotations

from enum import IntEnum
from typing import Any

from ..util.xdrquery import XDRQueryError, _leaf_value, _norm
from .runtime import (Optional as XdrOptional, Struct, Union, Array,
                      VarArray)


def to_jsonable(value: Any, t: Any = None) -> Any:
    """Convert an XDR value to plain dict/list/str/int for json.dumps.
    Leaves render exactly as xdrquery resolves them, so a value copied
    out of a dump matches the same entry via --filter-query."""
    if t is None:
        t = type(value)
    t = _norm(t)

    if isinstance(t, XdrOptional):
        if value is None:
            return None
        return to_jsonable(value, t.elem)
    if isinstance(t, (Array, VarArray)):
        return [to_jsonable(v, t.elem) for v in value]
    try:
        return _leaf_value(value, t)  # PublicKey/enum/str/opaque/int/bool
    except XDRQueryError:
        pass
    if isinstance(t, type) and issubclass(t, Struct):
        return {fn: to_jsonable(getattr(value, fn), ft)
                for fn, ft in t._FIELDS}
    if isinstance(t, type) and issubclass(t, Union):
        disc = value.disc
        disc_repr = disc.name if isinstance(disc, IntEnum) else int(disc)
        arm = t._ARMS.get(disc, t._DEFAULT_ARM
                          if t._DEFAULT_ARM != "_missing_" else None)
        if arm is None or arm[1] is None:
            return {"type": disc_repr}
        return {"type": disc_repr,
                arm[0]: to_jsonable(value.value, arm[1])}
    if isinstance(value, IntEnum):
        return value.name
    if isinstance(value, (bytes, bytearray)):
        return bytes(value).hex()
    if isinstance(value, (list, tuple)):
        return [to_jsonable(v) for v in value]
    return value
