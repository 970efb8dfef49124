"""XDR (RFC 4506) runtime: declarative types with canonical serialization.

The reference builds on xdrpp codegen from `.x` files (reference:
src/Makefile.am:46-51, docs/architecture.md:50-52 — "single, standard XDR for
canonical (hashed) format, history, and inter-node messaging").  Our build
replaces codegen with a small declarative runtime: types are described once as
Python class declarations and get canonical pack/unpack, equality, ordering,
repr and deep-copy for free.  The canonical byte encoding is exactly XDR:
big-endian 4-byte words, length-prefixed variable data, 4-byte padding.

Design notes:
- Canonical bytes are the hash domain (ledger hashes, tx hashes, bucket
  hashes) so serialization must be total and deterministic — no floats, no
  maps, no implicit defaults in the encoding.
- Hot-path hashing feeds the batch signature verifier; `xdr_to_bytes` is kept
  allocation-light (single bytearray writer).
"""

from __future__ import annotations

import struct
from enum import IntEnum
from typing import Any, Dict, List, Optional as Opt, Sequence, Tuple, Type


class XdrError(Exception):
    """Raised on malformed XDR input or out-of-range values."""


# ---------------------------------------------------------------------------
# Native codec hookup (see native_codec.py / native/src/pyext/xdr_codec.cpp)
# ---------------------------------------------------------------------------

# every concrete Struct/Union class, in creation order; the native codec
# compiles this world into a C schema program
_XDR_REGISTRY: List[type] = []
# bumped on class creation and register_arm so the native program recompiles
_XDR_GEN = [0]
_NC: List[Any] = [None]   # None = not loaded, False = disabled/unavailable


def _nc():
    """The native codec state if usable for the current schema
    generation, else None (callers then take the Python path)."""
    ns = _NC[0]
    if ns is None:
        try:
            from . import native_codec
            ns = native_codec.state()
        except Exception:
            ns = None
        if ns is None:
            _NC[0] = False
            return None
        _NC[0] = ns
    elif ns is False:
        return None
    if ns.gen != _XDR_GEN[0]:
        ns.refresh()
    return ns if ns.ok else None


# ---------------------------------------------------------------------------
# Reader / writer
# ---------------------------------------------------------------------------

class Writer:
    __slots__ = ("buf",)

    def __init__(self) -> None:
        self.buf = bytearray()

    def u32(self, v: int) -> None:
        if not 0 <= v <= 0xFFFFFFFF:
            raise XdrError(f"uint32 out of range: {v}")
        self.buf += v.to_bytes(4, "big")

    def i32(self, v: int) -> None:
        if not -(2**31) <= v < 2**31:
            raise XdrError(f"int32 out of range: {v}")
        self.buf += struct.pack(">i", v)

    def u64(self, v: int) -> None:
        if not 0 <= v <= 0xFFFFFFFFFFFFFFFF:
            raise XdrError(f"uint64 out of range: {v}")
        self.buf += v.to_bytes(8, "big")

    def i64(self, v: int) -> None:
        if not -(2**63) <= v < 2**63:
            raise XdrError(f"int64 out of range: {v}")
        self.buf += struct.pack(">q", v)

    def raw(self, b: bytes) -> None:
        self.buf += b

    def opaque(self, b: bytes) -> None:
        self.buf += b
        pad = (-len(b)) % 4
        if pad:
            self.buf += b"\x00" * pad


class Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise XdrError("unexpected end of XDR input")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u32(self) -> int:
        return int.from_bytes(self._take(4), "big")

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def u64(self) -> int:
        return int.from_bytes(self._take(8), "big")

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def opaque(self, n: int) -> bytes:
        b = self._take(n)
        pad = (-n) % 4
        if pad:
            p = self._take(pad)
            if p != b"\x00" * pad:
                raise XdrError("non-zero XDR padding")
        return b

    def done(self) -> bool:
        return self.pos == len(self.data)


# ---------------------------------------------------------------------------
# Type descriptors
# ---------------------------------------------------------------------------

class XdrType:
    """A type descriptor: knows how to pack/unpack/validate one value."""

    def pack(self, w: Writer, v: Any) -> None:
        raise NotImplementedError

    def unpack(self, r: Reader) -> Any:
        raise NotImplementedError

    def default(self) -> Any:
        raise NotImplementedError


class _Int32(XdrType):
    def pack(self, w: Writer, v: Any) -> None:
        w.i32(int(v))

    def unpack(self, r: Reader) -> int:
        return r.i32()

    def default(self) -> int:
        return 0


class _Uint32(XdrType):
    def pack(self, w: Writer, v: Any) -> None:
        w.u32(int(v))

    def unpack(self, r: Reader) -> int:
        return r.u32()

    def default(self) -> int:
        return 0


class _Int64(XdrType):
    def pack(self, w: Writer, v: Any) -> None:
        w.i64(int(v))

    def unpack(self, r: Reader) -> int:
        return r.i64()

    def default(self) -> int:
        return 0


class _Uint64(XdrType):
    def pack(self, w: Writer, v: Any) -> None:
        w.u64(int(v))

    def unpack(self, r: Reader) -> int:
        return r.u64()

    def default(self) -> int:
        return 0


class _Bool(XdrType):
    def pack(self, w: Writer, v: Any) -> None:
        w.u32(1 if v else 0)

    def unpack(self, r: Reader) -> bool:
        v = r.u32()
        if v not in (0, 1):
            raise XdrError(f"invalid bool encoding {v}")
        return bool(v)

    def default(self) -> bool:
        return False


Int32 = _Int32()
Uint32 = _Uint32()
Int64 = _Int64()
Uint64 = _Uint64()
Bool = _Bool()


class Opaque(XdrType):
    """Fixed-length opaque bytes."""

    def __init__(self, n: int) -> None:
        self.n = n

    def pack(self, w: Writer, v: Any) -> None:
        b = bytes(v)
        if len(b) != self.n:
            raise XdrError(f"opaque[{self.n}] got {len(b)} bytes")
        w.opaque(b)

    def unpack(self, r: Reader) -> bytes:
        return r.opaque(self.n)

    def default(self) -> bytes:
        return b"\x00" * self.n


class VarOpaque(XdrType):
    """Variable-length opaque bytes with a max size."""

    def __init__(self, max_len: int = 0xFFFFFFFF) -> None:
        self.max_len = max_len

    def pack(self, w: Writer, v: Any) -> None:
        b = bytes(v)
        if len(b) > self.max_len:
            raise XdrError(f"opaque<{self.max_len}> got {len(b)} bytes")
        w.u32(len(b))
        w.opaque(b)

    def unpack(self, r: Reader) -> bytes:
        n = r.u32()
        if n > self.max_len:
            raise XdrError(f"opaque<{self.max_len}> got {n} bytes")
        return r.opaque(n)

    def default(self) -> bytes:
        return b""


class XdrString(VarOpaque):
    """XDR string — same wire format as VarOpaque; value kept as bytes
    (the reference keeps strings as raw bytes too; validation is the
    application's job, e.g. manage-data names)."""


class Array(XdrType):
    """Fixed-length array of an element type."""

    def __init__(self, elem: Any, n: int) -> None:
        self.elem = _resolve(elem)
        self.n = n

    def pack(self, w: Writer, v: Any) -> None:
        if len(v) != self.n:
            raise XdrError(f"array[{self.n}] got {len(v)} elements")
        for e in v:
            self.elem.pack(w, e)

    def unpack(self, r: Reader) -> list:
        return [self.elem.unpack(r) for _ in range(self.n)]

    def default(self) -> list:
        return [self.elem.default() for _ in range(self.n)]


class VarArray(XdrType):
    """Variable-length array with a max size."""

    def __init__(self, elem: Any, max_len: int = 0xFFFFFFFF) -> None:
        self.elem = _resolve(elem)
        self.max_len = max_len

    def pack(self, w: Writer, v: Any) -> None:
        if len(v) > self.max_len:
            raise XdrError(f"array<{self.max_len}> got {len(v)} elements")
        w.u32(len(v))
        for e in v:
            self.elem.pack(w, e)

    def unpack(self, r: Reader) -> list:
        n = r.u32()
        if n > self.max_len:
            raise XdrError(f"array<{self.max_len}> got {n} elements")
        return [self.elem.unpack(r) for _ in range(n)]

    def default(self) -> list:
        return []


class Optional(XdrType):
    """XDR optional (`*T`): bool presence flag then the value."""

    def __init__(self, elem: Any) -> None:
        self.elem = _resolve(elem)

    def pack(self, w: Writer, v: Any) -> None:
        if v is None:
            w.u32(0)
        else:
            w.u32(1)
            self.elem.pack(w, v)

    def unpack(self, r: Reader) -> Any:
        flag = r.u32()
        if flag == 0:
            return None
        if flag != 1:
            raise XdrError(f"invalid optional flag {flag}")
        return self.elem.unpack(r)

    def default(self) -> None:
        return None


class EnumType(XdrType):
    """Wraps a Python IntEnum as an XDR enum (strict: unknown values reject)."""

    def __init__(self, enum_cls: Type[IntEnum]) -> None:
        self.enum_cls = enum_cls
        self._members = enum_cls._value2member_map_

    def pack(self, w: Writer, v: Any) -> None:
        if v.__class__ is self.enum_cls:        # hot path: already typed
            w.i32(v._value_)
            return
        try:
            w.i32(int(self.enum_cls(v)))
        except ValueError:
            raise XdrError(
                f"invalid {self.enum_cls.__name__} value {v!r}") from None

    def unpack(self, r: Reader) -> IntEnum:
        raw = r.i32()
        m = self._members.get(raw)
        if m is None:
            raise XdrError(
                f"invalid {self.enum_cls.__name__} value {raw}")
        return m

    def default(self) -> IntEnum:
        return next(iter(self.enum_cls))


class Lazy(XdrType):
    """Deferred type reference for recursive XDR types (e.g. ClaimPredicate,
    SCPQuorumSet). Takes a zero-arg callable resolved on first use."""

    def __init__(self, thunk) -> None:
        self._thunk = thunk
        self._t: Opt[XdrType] = None

    def _get(self) -> XdrType:
        if self._t is None:
            self._t = _resolve(self._thunk())
        return self._t

    def pack(self, w: Writer, v: Any) -> None:
        self._get().pack(w, v)

    def unpack(self, r: Reader) -> Any:
        return self._get().unpack(r)

    def default(self) -> Any:
        return self._get().default()


_ENUM_TYPES: Dict[type, EnumType] = {}


def _resolve(t: Any) -> XdrType:
    """Accept XdrType instances, Struct/Union classes, and IntEnum classes."""
    if isinstance(t, XdrType):
        return t
    if isinstance(t, type) and issubclass(t, (Struct, Union)):
        return _Composite(t)
    if isinstance(t, type) and issubclass(t, IntEnum):
        et = _ENUM_TYPES.get(t)
        if et is None:
            et = _ENUM_TYPES[t] = EnumType(t)
        return et
    raise TypeError(f"not an XDR type: {t!r}")


class _Composite(XdrType):
    """Adapter: a Struct/Union class used as a field type."""

    def __init__(self, cls: type) -> None:
        self.cls = cls

    def pack(self, w: Writer, v: Any) -> None:
        if not isinstance(v, self.cls):
            raise XdrError(f"expected {self.cls.__name__}, got {type(v).__name__}")
        v._pack(w)

    def unpack(self, r: Reader) -> Any:
        return self.cls._unpack(r)

    def default(self) -> Any:
        return self.cls()


# ---------------------------------------------------------------------------
# Struct
# ---------------------------------------------------------------------------

def _emit_pack(ft, expr: str, ns: dict, uid: List[int],
               indent: str) -> List[str]:
    """Specialized pack statements for one value of type `ft` (falls
    back to the type's bound pack method when no specialization
    applies).  Scalar writes inline onto the Writer; composites call
    `._pack` directly, skipping the _Composite isinstance adapter."""
    i = uid[0]
    uid[0] += 1
    if isinstance(ft, _Int32):
        return [f"{indent}w.i32({expr})"]
    if isinstance(ft, _Uint32):
        return [f"{indent}w.u32({expr})"]
    if isinstance(ft, _Int64):
        return [f"{indent}w.i64({expr})"]
    if isinstance(ft, _Uint64):
        return [f"{indent}w.u64({expr})"]
    if isinstance(ft, _Bool):
        return [f"{indent}w.u32(1 if {expr} else 0)"]
    if isinstance(ft, _Composite):
        return [f"{indent}{expr}._pack(w)"]
    if isinstance(ft, Optional):
        tmp = f"_t{i}"
        inner = _emit_pack(ft.elem, tmp, ns, uid, indent + "    ")
        return ([f"{indent}{tmp} = {expr}",
                 f"{indent}if {tmp} is None:",
                 f"{indent}    w.u32(0)",
                 f"{indent}else:",
                 f"{indent}    w.u32(1)"] + inner)
    if isinstance(ft, VarArray):
        tmp = f"_t{i}"
        x = f"_x{i}"
        inner = _emit_pack(ft.elem, x, ns, uid, indent + "    ")
        out = [f"{indent}{tmp} = {expr}"]
        if ft.max_len < 0xFFFFFFFF:
            ns.setdefault("_XdrError", XdrError)
            out += [f"{indent}if len({tmp}) > {ft.max_len}:",
                    f"{indent}    raise _XdrError('array too long')"]
        out += [f"{indent}w.u32(len({tmp}))",
                f"{indent}for {x} in {tmp}:"] + inner
        return out
    # Opaque/VarOpaque/XdrString/EnumType/Array/Lazy: bound method
    ns[f"_p{i}"] = ft.pack
    return [f"{indent}_p{i}(w, {expr})"]


def _gen_struct_codecs(cls):
    """exec-specialized _pack/_unpack for one Struct type: straight-line
    per-field statements with scalar writes inlined — removes the
    generic loop/getattr/adapter overhead from the serialization hot
    path (hashing, DB writes, meta streams all funnel through here).
    On errors the generic slow path re-runs to produce the
    field-attributed message (the output buffer is abandoned by the
    raise either way)."""
    fields = cls._FIELDS
    pack_ns: dict = {}
    uid = [0]
    body: List[str] = []
    for fn, ft in fields:
        body += _emit_pack(ft, f"self.{fn}", pack_ns, uid, "    ")
    src = ["def _fast_pack(self, w):"] + (body or ["    pass"])
    exec("\n".join(src), pack_ns)          # noqa: S102 — trusted codegen
    fast_pack = pack_ns["_fast_pack"]

    def _pack(self, w):
        try:
            fast_pack(self, w)
        except (XdrError, AttributeError, TypeError):
            Struct._generic_pack(self, w)  # re-raise with field context
            raise                           # pragma: no cover (safety)

    unpack_ns = {("_u%d" % i): ft.unpack for i, (_, ft) in
                 enumerate(fields)}
    src = (["def _fast_unpack(cls, r):",
            "    obj = cls.__new__(cls)",
            "    d = obj.__dict__"] +
           ["    d['%s'] = _u%d(r)" % (fn, i)
            for i, (fn, _) in enumerate(fields)] +
           ["    return obj"])
    exec("\n".join(src), unpack_ns)        # noqa: S102 — trusted codegen
    return _pack, unpack_ns["_fast_unpack"]


def _clone_value(v: Any) -> Any:
    """Deep-copy an XDR field value (generic path for fields whose
    static type doesn't allow specialization — Lazy, nested optionals).
    Immutables (ints, bytes, str, None, enums, bools) are shared;
    Struct/Union recurse; sequences rebuild; mutable byte buffers
    snapshot to bytes."""
    cl = getattr(v, "clone", None)
    if cl is not None:
        return cl()
    t = v.__class__
    if t is list:
        return [_clone_value(x) for x in v]
    if t is tuple:
        return tuple(_clone_value(x) for x in v)
    if t is bytearray or t is memoryview:
        return bytes(v)
    return v


# clone modes: how to deep-copy a field of a given XDR type without
# generic dispatch (0: immutable leaf, 1: .clone(), 2: generic
# _clone_value, 3: bytes-ish, 4: list of leaves, 5: list of composites,
# 6: optional composite)
def _clone_mode(ft) -> int:
    if isinstance(ft, (_Int32, _Uint32, _Int64, _Uint64, _Bool, EnumType)):
        return 0
    if isinstance(ft, (Opaque, VarOpaque)):
        return 3
    if isinstance(ft, _Composite):
        return 1
    if isinstance(ft, (Array, VarArray)):
        em = _clone_mode(ft.elem)
        if em == 0:
            return 4
        if em == 1:
            return 5
        return 2
    if isinstance(ft, Optional):
        em = _clone_mode(ft.elem)
        if em == 0:
            return 0
        if em == 1:
            return 6
        return 2
    return 2


_CLONE_STMTS = {
    0: "    d['{f}'] = s['{f}']",
    1: "    d['{f}'] = s['{f}'].clone()",
    2: "    d['{f}'] = _cv(s['{f}'])",
    3: ("    _t = s['{f}']\n"
        "    d['{f}'] = _t if _t.__class__ is bytes else bytes(_t)"),
    4: "    d['{f}'] = list(s['{f}'])",
    5: "    d['{f}'] = [_x.clone() for _x in s['{f}']]",
    6: ("    _t = s['{f}']\n"
        "    d['{f}'] = None if _t is None else _t.clone()"),
}


def _gen_struct_clone(cls):
    """exec-specialized structural deep copy: straight-line per-field
    code chosen from the field's static XDR type — the LedgerTxn
    load/commit hot path runs this instead of generic recursion."""
    src = ["def _fast_clone(self):",
           "    obj = _new(_cls)",
           "    d = obj.__dict__",
           "    s = self.__dict__"]
    for fn, ft in cls._FIELDS:
        src.append(_CLONE_STMTS[_clone_mode(ft)].format(f=fn))
    src.append("    return obj")
    ns = {"_cls": cls, "_new": cls.__new__, "_cv": _clone_value}
    exec("\n".join(src), ns)               # noqa: S102 — trusted codegen
    return ns["_fast_clone"]


class _StructMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        fields = ns.get("FIELDS")
        if fields is not None:
            cls._FIELDS = [(fn, _resolve(ft)) for fn, ft in fields]
            cls._FIELD_NAMES = tuple(fn for fn, _ in fields)
            pack, unpack = _gen_struct_codecs(cls)
            cls._pack = pack
            cls._unpack = classmethod(unpack)
            cls._py_clone = _gen_struct_clone(cls)
            _XDR_REGISTRY.append(cls)
            _XDR_GEN[0] += 1
        return cls


class Struct(metaclass=_StructMeta):
    """Declarative XDR struct.

    Subclasses set ``FIELDS = [("name", Type), ...]``; instances take keyword
    arguments (missing fields get XDR zero-defaults).
    """

    FIELDS: Sequence[Tuple[str, Any]] = []
    _FIELDS: List[Tuple[str, XdrType]] = []
    _FIELD_NAMES: Tuple[str, ...] = ()

    def __init__(self, **kw: Any) -> None:
        for fn, ft in self._FIELDS:
            if fn in kw:
                setattr(self, fn, kw.pop(fn))
            else:
                setattr(self, fn, ft.default())
        if kw:
            raise TypeError(
                f"{type(self).__name__}: unknown fields {sorted(kw)}")

    def _generic_pack(self, w: Writer) -> None:
        """Slow path kept for field-attributed error messages; the
        metaclass installs an exec-specialized _pack per subclass."""
        for fn, ft in self._FIELDS:
            try:
                ft.pack(w, getattr(self, fn))
            except XdrError as e:
                raise XdrError(f"{type(self).__name__}.{fn}: {e}") from None

    _pack = _generic_pack

    @classmethod
    def _unpack(cls, r: Reader) -> "Struct":
        obj = cls.__new__(cls)
        for fn, ft in cls._FIELDS:
            setattr(obj, fn, ft.unpack(r))
        return obj

    def to_bytes(self) -> bytes:
        nc = _nc()
        if nc is not None:
            try:
                return nc.pack(nc.cap, self.__class__._nidx, self)
            except Exception:
                pass   # Python path below re-raises with field context
        w = Writer()
        self._pack(w)
        return bytes(w.buf)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Struct":
        nc = _nc()
        if nc is not None:
            try:
                return nc.unpack(nc.cap, cls._nidx, data)
            except Exception:
                pass   # Python path below re-raises with context
        r = Reader(data)
        obj = cls._unpack(r)
        if not r.done():
            raise XdrError(f"{cls.__name__}: {len(data) - r.pos} trailing bytes")
        return obj

    def clone(self) -> "Struct":
        """Structural deep copy — no serialize/parse roundtrip (the
        LedgerTxn aliasing-protection hot path). The native-codec check
        is inlined rather than routed through _nc(): clone is the
        single hottest XDR call in ledger replay (16.5k calls per 64
        ledgers, scripts/profile_catchup.py) and the extra function
        call + refresh bookkeeping measured ~60% overhead on top of
        the native clone itself."""
        cls = self.__class__
        ns = _NC[0]
        if ns is not None and ns is not False and ns.gen == _XDR_GEN[0] \
                and ns.ok:
            try:
                return ns.clone(ns.cap, cls._nidx, self)
            except Exception:
                pass
        elif (nc := _nc()) is not None:
            try:
                return nc.clone(nc.cap, cls._nidx, self)
            except Exception:
                pass
        pc = getattr(cls, "_py_clone", None)
        if pc is not None:
            return pc(self)
        obj = cls.__new__(cls)
        for fn in self._FIELD_NAMES:
            obj.__dict__[fn] = _clone_value(self.__dict__[fn])
        return obj

    def __eq__(self, other: Any) -> bool:
        if type(self) is not type(other):
            return NotImplemented
        return all(getattr(self, f) == getattr(other, f)
                   for f in self._FIELD_NAMES)

    def __hash__(self) -> int:
        return hash(self.to_bytes())

    def __lt__(self, other: Any) -> bool:
        # canonical-bytes ordering, matching xdrpp's operator< on serialized
        # form where the reference sorts XDR values
        return self.to_bytes() < other.to_bytes()

    def __repr__(self) -> str:
        parts = ", ".join(
            f"{f}={getattr(self, f)!r}" for f in self._FIELD_NAMES)
        return f"{type(self).__name__}({parts})"

    def copy(self) -> "Struct":
        return self.clone()


# ---------------------------------------------------------------------------
# Union
# ---------------------------------------------------------------------------

class _UnionMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        arms = ns.get("ARMS")
        if arms:
            switch = ns.get("SWITCH")
            if switch is None:
                for b in bases:
                    switch = getattr(b, "SWITCH", None)
                    if switch is not None:
                        break
            cls._SWITCH = _resolve(switch)
            resolved: Dict[Any, Opt[Tuple[str, Opt[XdrType]]]] = {}
            for disc, arm in arms.items():
                if arm is None:
                    resolved[disc] = None  # void arm
                else:
                    an, at = arm
                    resolved[disc] = (an, _resolve(at) if at is not None else None)
            cls._ARMS = resolved
            default = ns.get("DEFAULT_ARM",
                             getattr(cls, "DEFAULT_ARM", "_missing_"))
            if default not in ("_missing_", None):
                an, at = default
                default = (an, _resolve(at) if at is not None else None)
            cls._DEFAULT_ARM = default
            # per-arm clone modes (see _clone_mode): void arms and leaf
            # payloads share, composites .clone(), anything else generic
            modes: Dict[Any, int] = {}
            for disc, arm in cls._ARMS.items():
                if arm is None or arm[1] is None:
                    modes[disc] = 0
                else:
                    modes[disc] = _clone_mode(arm[1])
            if default not in ("_missing_", None) and default[1] is not None:
                cls._DEFAULT_CLONE_MODE = _clone_mode(default[1])
            else:
                cls._DEFAULT_CLONE_MODE = 0 if default is None else 2
            cls._ARM_CLONE_MODES = modes
            # per-arm pack/unpack tables: one dict hit replaces the
            # _arm_for lookup + adapter dispatch on the (hot) wire path
            cls._ARM_PACKERS = {
                disc: (None if arm is None or arm[1] is None
                       else _arm_packer(arm[1]))
                for disc, arm in cls._ARMS.items()}
            cls._ARM_UNPACKERS = {
                disc: (arm[0] if arm is not None else None,
                       arm[1].unpack if arm is not None
                       and arm[1] is not None else None)
                for disc, arm in cls._ARMS.items()}
            if default == "_missing_":
                cls._DEFAULT_PACKER = "_missing_"
                cls._DEFAULT_UNPACKER = ("_missing_", None)
            elif default is None:               # void default arm
                cls._DEFAULT_PACKER = None
                cls._DEFAULT_UNPACKER = (None, None)
            else:
                cls._DEFAULT_PACKER = (None if default[1] is None
                                       else _arm_packer(default[1]))
                cls._DEFAULT_UNPACKER = (
                    default[0],
                    default[1].unpack if default[1] is not None else None)
            _XDR_REGISTRY.append(cls)
            _XDR_GEN[0] += 1
        return cls


def _pack_composite(w: Writer, v: Any) -> None:
    v._pack(w)


def _arm_packer(at: XdrType):
    """Direct packer for a union arm, skipping the adapter layer for
    composites (the dominant arm kind in the protocol)."""
    if isinstance(at, _Composite):
        return _pack_composite
    return at.pack


_UNSET = object()


class Union(metaclass=_UnionMeta):
    """Declarative XDR union.

    Subclasses set ``SWITCH`` (an enum class or integer XdrType) and
    ``ARMS = {disc_value: ("arm_name", ArmType) | ("arm_name", None) | None}``.
    ``None`` as the whole arm means void.  ``DEFAULT_ARM`` (same shapes) covers
    unlisted discriminants.  Construct as ``U(disc)`` for void arms or
    ``U(disc, value)`` / ``U(disc, arm_name=value)``.
    """

    SWITCH: Any = None
    ARMS: Dict[Any, Any] = {}
    _SWITCH: XdrType
    _ARMS: Dict[Any, Opt[Tuple[str, Opt[XdrType]]]]
    _DEFAULT_ARM: Any = "_missing_"

    def __init__(self, disc: Any = _UNSET, value: Any = _UNSET, **kw: Any) -> None:
        if disc is _UNSET:
            disc = self._SWITCH.default()
        self.disc = disc
        # inline the overwhelmingly common listed-arm hit; _arm_for
        # handles default arms and invalid discriminants
        arm = self._ARMS.get(disc, _UNSET)
        if arm is _UNSET:
            arm = self._arm_for(disc)
        if arm is None:
            if value is not _UNSET or kw:
                raise TypeError(f"{type(self).__name__}({disc!r}) is a void arm")
            self.arm_name = None
            self.value = None
            return
        an, at = arm
        self.arm_name = an
        if kw:
            if value is not _UNSET or list(kw) != [an]:
                raise TypeError(
                    f"{type(self).__name__}: expected keyword {an!r}")
            value = kw[an]
        if value is _UNSET:
            value = at.default() if at is not None else None
        self.value = value

    @classmethod
    def register_arm(cls, disc: Any, arm_name: Opt[str],
                     arm_type: Any) -> None:
        """Extend a union with a new arm after class creation (the
        protocol-extension hook used by xdr/contract.py) — keeps the
        precomputed pack/unpack/clone tables in sync with _ARMS."""
        if arm_name is None:
            cls.ARMS[disc] = None
            cls._ARMS[disc] = None
            cls._ARM_PACKERS[disc] = None
            cls._ARM_UNPACKERS[disc] = (None, None)
            cls._ARM_CLONE_MODES[disc] = 0
            return
        at = _resolve(arm_type) if arm_type is not None else None
        cls.ARMS[disc] = (arm_name, arm_type)
        cls._ARMS[disc] = (arm_name, at)
        cls._ARM_PACKERS[disc] = None if at is None else _arm_packer(at)
        cls._ARM_UNPACKERS[disc] = (
            arm_name, at.unpack if at is not None else None)
        cls._ARM_CLONE_MODES[disc] = 0 if at is None else _clone_mode(at)
        _XDR_GEN[0] += 1   # recompile the native schema program

    @classmethod
    def _arm_for(cls, disc: Any) -> Opt[Tuple[str, Opt[XdrType]]]:
        if disc in cls._ARMS:
            return cls._ARMS[disc]
        if cls._DEFAULT_ARM != "_missing_":
            return cls._DEFAULT_ARM
        raise XdrError(
            f"{cls.__name__}: invalid discriminant {disc!r}")

    def _pack(self, w: Writer) -> None:
        cls = self.__class__
        d = self.disc
        cls._SWITCH.pack(w, d)
        try:
            p = cls._ARM_PACKERS[d]
        except KeyError:
            p = cls._DEFAULT_PACKER
            if p == "_missing_":
                raise XdrError(
                    f"{cls.__name__}: invalid discriminant {d!r}") from None
        if p is not None:
            try:
                p(w, self.value)
            except (XdrError, AttributeError, TypeError) as e:
                an = (self.arm_name or "?")
                raise XdrError(
                    f"{cls.__name__}.{an}: {e}") from None

    @classmethod
    def _unpack(cls, r: Reader) -> "Union":
        disc = cls._SWITCH.unpack(r)
        obj = cls.__new__(cls)
        obj.disc = disc
        try:
            an, u = cls._ARM_UNPACKERS[disc]
        except KeyError:
            an, u = cls._DEFAULT_UNPACKER
            if an == "_missing_":
                raise XdrError(
                    f"{cls.__name__}: invalid discriminant {disc!r}") \
                    from None
        obj.arm_name = an
        obj.value = u(r) if u is not None else None
        return obj

    def to_bytes(self) -> bytes:
        nc = _nc()
        if nc is not None:
            try:
                return nc.pack(nc.cap, self.__class__._nidx, self)
            except Exception:
                pass   # Python path below re-raises with arm context
        w = Writer()
        self._pack(w)
        return bytes(w.buf)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Union":
        nc = _nc()
        if nc is not None:
            try:
                return nc.unpack(nc.cap, cls._nidx, data)
            except Exception:
                pass   # Python path below re-raises with context
        r = Reader(data)
        obj = cls._unpack(r)
        if not r.done():
            raise XdrError(f"{cls.__name__}: {len(data) - r.pos} trailing bytes")
        return obj

    def clone(self) -> "Union":
        """Structural deep copy (see Struct.clone); arm payloads are
        copied per the statically computed per-arm clone mode. Native
        check inlined as in Struct.clone (hot path)."""
        cls = self.__class__
        ns = _NC[0]
        if ns is not None and ns is not False and ns.gen == _XDR_GEN[0] \
                and ns.ok:
            try:
                return ns.clone(ns.cap, cls._nidx, self)
            except Exception:
                pass
        elif (nc := _nc()) is not None:
            try:
                return nc.clone(nc.cap, cls._nidx, self)
            except Exception:
                pass
        obj = cls.__new__(cls)
        obj.disc = d = self.disc
        obj.arm_name = self.arm_name
        v = self.value
        m = cls._ARM_CLONE_MODES.get(d, cls._DEFAULT_CLONE_MODE)
        if m == 0:
            obj.value = v
        elif m == 1:
            obj.value = v.clone()
        elif m == 3:
            obj.value = v if v.__class__ is bytes else bytes(v)
        elif m == 4:
            obj.value = list(v)
        elif m == 5:
            obj.value = [x.clone() for x in v]
        elif m == 6:
            obj.value = None if v is None else v.clone()
        else:
            obj.value = _clone_value(v)
        return obj

    def __eq__(self, other: Any) -> bool:
        if type(self) is not type(other):
            return NotImplemented
        return self.disc == other.disc and self.value == other.value

    def __hash__(self) -> int:
        return hash(self.to_bytes())

    def __lt__(self, other: Any) -> bool:
        return self.to_bytes() < other.to_bytes()

    def __repr__(self) -> str:
        if self.arm_name is None:
            return f"{type(self).__name__}({self.disc!r})"
        return f"{type(self).__name__}({self.disc!r}, {self.value!r})"

    def copy(self) -> "Union":
        return self.clone()


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def xdr_to_bytes(v: Any) -> bytes:
    """Serialize any XDR value (struct/union instance)."""
    return v.to_bytes()


def xdr_from_bytes(cls: type, data: bytes) -> Any:
    return cls.from_bytes(data)
