"""xdrquery: a small query DSL over declarative XDR types.

Reference: src/util/xdrquery/ (XDRQuery.h:30-35, XDRFieldResolver.h:365-380,
XDRQueryEval.h) — queries are boolean expressions over dotted field paths
into an XDR message, e.g.::

    data.account.balance >= 100000 || data.trustLine.balance < 5000

Semantics (matching the reference's test suite):
- Walking through a union selects the active arm; naming a *valid but
  inactive* arm resolves to MISSING and every comparison on it is false.
- A path ending on an unset optional resolves to NULL; ``== NULL`` /
  ``!= NULL`` are the only comparisons allowed against the NULL literal.
- Leaf conversions mirror XDR-to-JSON: enums → their name strings,
  public keys → strkey ('G...'), fixed opaques → hex strings, Assets →
  virtual {assetCode, issuer} (+ liquidityPoolID for pool shares), a
  union's discriminant is addressable by its switch name (``type``).
- Integer literals are range-checked against the field's XDR type;
  comparing a string to an int field (or vice versa) is an error.

The reference parses with flex/bison; here a hand-rolled tokenizer +
recursive-descent parser (grammar: ``or := and ('||' and)*``,
``and := cmp ('&&' cmp)*``, ``cmp := operand OP operand | '(' or ')'``)
keeps it dependency-free.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Sequence, Tuple

from ..xdr.runtime import (EnumType, Opaque, Optional as XdrOptional,
                           Struct, Union, VarOpaque, XdrString, _Bool,
                           _Composite, _Int32, _Int64, _Uint32, _Uint64)


def _norm(t: Any) -> Any:
    """Unwrap the runtime's _Composite adapter to the Struct/Union
    class it wraps."""
    return t.cls if isinstance(t, _Composite) else t


class XDRQueryError(Exception):
    """Raised on parse errors, invalid field paths, or type mismatches."""


class _Missing:
    """Union arm not selected — comparisons are always false."""

    def __repr__(self) -> str:
        return "MISSING"


class _Null:
    """Optional field not set — equal only to the NULL literal."""

    def __repr__(self) -> str:
        return "NULL"


MISSING = _Missing()
NULL = _Null()

_INT_RANGES = {
    _Int32: (-2**31, 2**31 - 1),
    _Uint32: (0, 2**32 - 1),
    _Int64: (-2**63, 2**63 - 1),
    _Uint64: (0, 2**64 - 1),
}

# the switch name unions are addressable by (reference: xdrpp names the
# discriminant after the union's switch declaration; stellar XDR uses
# `type` for every union our queries target)
_SWITCH_NAME = "type"

_ASSET_LEAVES = ("assetCode", "issuer", "liquidityPoolID")


def _is_asset_union(t: Any) -> bool:
    """Asset / TrustLineAsset / ChangeTrustAsset unions get a simplified
    {assetCode, issuer[, liquidityPoolID]} view
    (reference: XDRFieldResolver.h:340-354)."""
    t = _norm(t)
    if not (isinstance(t, type) and issubclass(t, Union)):
        return False
    arm_names = {arm[0] for arm in t._ARMS.values() if arm is not None}
    return "alphaNum4" in arm_names


def _is_public_key(t: Any) -> bool:
    from ..xdr.types import PublicKey
    t = _norm(t)
    return isinstance(t, type) and issubclass(t, PublicKey)


def _leaf_value(value: Any, t: Any) -> Any:
    """Convert a resolved leaf to its query representation."""
    from ..crypto.strkey import StrKey
    if _is_public_key(t):
        return StrKey.encode_ed25519_public(bytes(value.value))
    if isinstance(t, EnumType):
        return t.enum_cls(value).name
    if isinstance(t, XdrString):
        return bytes(value).decode("utf-8", "replace")
    if isinstance(t, Opaque):
        return bytes(value).hex()
    if isinstance(t, VarOpaque):
        return bytes(value).hex()
    if isinstance(t, _Bool):
        return bool(value)
    if isinstance(t, (_Int32, _Uint32, _Int64, _Uint64)):
        return int(value)
    raise XDRQueryError(
        f"field of type {getattr(t, '__name__', type(t).__name__)} "
        "is not a comparable leaf")


def _leaf_kind(t: Any) -> str:
    if isinstance(t, (_Int32, _Uint32, _Int64, _Uint64)):
        return "int"
    if isinstance(t, _Bool):
        return "bool"
    return "str"


def _asset_leaf(value: Any, t: Any, comp: str) -> Tuple[Any, Any]:
    """Resolve assetCode/issuer/liquidityPoolID on an asset union."""
    from ..crypto.strkey import StrKey
    arm_name = value.arm_name
    if comp == "liquidityPoolID":
        if arm_name in ("liquidityPoolID", "liquidityPool"):
            return bytes(value.value).hex(), Opaque(32)
        return MISSING, Opaque(32)
    if arm_name not in ("alphaNum4", "alphaNum12"):
        return MISSING, XdrString()
    alpha = value.value
    if comp == "assetCode":
        code = bytes(alpha.assetCode).rstrip(b"\x00")
        return code.decode("utf-8", "replace"), XdrString()
    return StrKey.encode_ed25519_public(
        bytes(alpha.issuer.value)), XdrString()


def validate_path(t: Any, path: Sequence[str]) -> Any:
    """Statically check `path` against type `t`, exploring every union
    arm; returns the leaf's XdrType-ish descriptor.  Raises
    XDRQueryError when no arm makes the path valid (reference:
    getXDRFieldValidated)."""
    t = _norm(t)
    if isinstance(t, XdrOptional):
        return validate_path(t.elem, path)
    if not path:
        if _is_public_key(t):
            return XdrString()
        if isinstance(t, (EnumType, XdrString, Opaque, VarOpaque, _Bool,
                          _Int32, _Uint32, _Int64, _Uint64)):
            return t
        raise XDRQueryError("field path ends on a non-leaf value")
    comp, rest = path[0], path[1:]
    if isinstance(t, type) and issubclass(t, Struct):
        for fn, ft in t._FIELDS:
            if fn == comp:
                return validate_path(ft, rest)
        raise XDRQueryError(f"invalid field '{comp}'")
    if _is_asset_union(t) and comp in _ASSET_LEAVES:
        if rest:
            raise XDRQueryError(f"'{comp}' is a leaf field")
        return XdrString() if comp != "liquidityPoolID" else Opaque(32)
    if isinstance(t, type) and issubclass(t, Union):
        if comp == _SWITCH_NAME:
            if rest:
                raise XDRQueryError(f"'{_SWITCH_NAME}' is a leaf field")
            return t._SWITCH
        for arm in t._ARMS.values():
            if arm is None or arm[1] is None:
                continue
            if arm[0] == comp:
                return validate_path(arm[1], rest)
        raise XDRQueryError(f"invalid field '{comp}'")
    raise XDRQueryError(f"invalid field path at '{comp}'")


def resolve_field(obj: Any, path: Sequence[str]) -> Tuple[Any, Any]:
    """Resolve a dotted path against an XDR message instance.

    Returns (value, leaf_type) where value may be MISSING (union arm not
    selected) or NULL (optional unset)."""
    t: Any = type(obj)
    value: Any = obj
    i = 0
    while i < len(path):
        t = _norm(t)
        comp = path[i]
        if isinstance(t, type) and issubclass(t, Struct):
            ft = None
            for fn, ft_ in t._FIELDS:
                if fn == comp:
                    ft = ft_
                    break
            if ft is None:
                raise XDRQueryError(f"invalid field '{comp}'")
            value = getattr(value, comp)
            t = ft
            if isinstance(t, XdrOptional):
                if value is None:
                    if i + 1 != len(path):
                        raise XDRQueryError(
                            f"invalid field path past unset '{comp}'")
                    return NULL, t.elem
                t = t.elem
            i += 1
            continue
        if _is_asset_union(t) and comp in _ASSET_LEAVES:
            if i + 1 != len(path):
                raise XDRQueryError(f"'{comp}' is a leaf field")
            return _asset_leaf(value, t, comp)
        if isinstance(t, type) and issubclass(t, Union):
            if comp == _SWITCH_NAME:
                if i + 1 != len(path):
                    raise XDRQueryError(f"'{_SWITCH_NAME}' is a leaf")
                disc = value.disc
                if isinstance(t._SWITCH, EnumType):
                    return t._SWITCH.enum_cls(disc).name, t._SWITCH
                return int(disc), t._SWITCH
            arm = t._ARMS.get(value.disc)
            active_name = arm[0] if arm is not None else None
            if comp == active_name:
                t = arm[1]
                value = value.value
                i += 1
                continue
            # valid-but-inactive arm → MISSING; still validate statically
            for a in t._ARMS.values():
                if a is not None and a[0] == comp and a[1] is not None:
                    leaf = validate_path(a[1], path[i + 1:])
                    return MISSING, leaf
            raise XDRQueryError(f"invalid field '{comp}'")
        raise XDRQueryError(f"invalid field path at '{comp}'")
    return _leaf_value(value, _norm(t)), _norm(t)


# ---------------------------------------------------------------------------
# Tokenizer / parser
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<op>==|!=|<=|>=|<|>|\|\||&&|\(|\)|,)
    | (?P<int>-?\d+)(?![\w.])
    | '(?P<sq>[^']*)'
    | "(?P<dq>[^"]*)"
    | (?P<path>[A-Za-z_][A-Za-z_0-9]*(?:\.[A-Za-z_][A-Za-z_0-9]*)*)
    )""", re.VERBOSE)


def _tokenize(query: str) -> List[Tuple[str, Any]]:
    tokens: List[Tuple[str, Any]] = []
    pos = 0
    while pos < len(query):
        m = _TOKEN_RE.match(query, pos)
        if m is None or m.end() == pos:
            rest = query[pos:].strip()
            if not rest:
                break
            raise XDRQueryError(f"syntax error near '{rest[:20]}'")
        if m.group("op"):
            tokens.append(("op", m.group("op")))
        elif m.group("int") is not None:
            tokens.append(("int", int(m.group("int"))))
        elif m.group("sq") is not None:
            tokens.append(("str", m.group("sq")))
        elif m.group("dq") is not None:
            tokens.append(("str", m.group("dq")))
        else:
            p = m.group("path")
            if p == "NULL":
                tokens.append(("null", None))
            else:
                tokens.append(("path", p.split(".")))
        pos = m.end()
    return tokens


class _Comparison:
    _OPS = {
        "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
        "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
        ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    }

    def __init__(self, left, op, right):
        self.left, self.op, self.right = left, op, right
        self._validated = False

    def _operand(self, node, obj):
        kind, v = node
        if kind == "path":
            return resolve_field(obj, v)
        return v, kind

    def _check_types(self, lv, lt, rv, rt) -> None:
        """First-evaluation validation (reference: XDRMatcher lazy
        parse + validate)."""
        sides = [(lv, lt), (rv, rt)]
        for (v, t), (ov, ot) in (sides, sides[::-1]):
            if not hasattr(t, "pack"):  # literal
                continue
            # t is an XdrType leaf descriptor; other side must agree
            if hasattr(ot, "pack"):
                if _leaf_kind(t) != _leaf_kind(ot):
                    raise XDRQueryError(
                        "type mismatch: cannot compare "
                        f"{_leaf_kind(t)} field with {_leaf_kind(ot)} "
                        "field")
                continue
            if ot == "null":
                if self.op not in ("==", "!="):
                    raise XDRQueryError(
                        "NULL only supports == and != comparisons")
                continue
            kind = _leaf_kind(t)
            if ot == "int":
                if kind != "int":
                    raise XDRQueryError(
                        "type mismatch: int literal vs non-int field")
                rng = _INT_RANGES.get(type(t))
                if rng and not rng[0] <= ov <= rng[1]:
                    raise XDRQueryError(
                        f"int literal {ov} out of range for field")
            elif ot == "str" and kind != "str":
                raise XDRQueryError(
                    "type mismatch: string literal vs non-string field")

    def eval(self, obj) -> bool:
        lv, lt = self._operand(self.left, obj)
        rv, rt = self._operand(self.right, obj)
        if not self._validated:
            # statically validate paths across all union arms once
            for kind, v in (self.left, self.right):
                if kind == "path":
                    validate_path(type(obj), v)
            self._check_types(lv, lt, rv, rt)
            self._validated = True
        if lv is MISSING or rv is MISSING:
            return False
        ln = lv is NULL or (self.left[0] == "null")
        rn = rv is NULL or (self.right[0] == "null")
        if ln or rn:
            if self.op == "==":
                return ln and rn
            if self.op == "!=":
                return ln != rn
            raise XDRQueryError("NULL only supports == and !=")
        return self._OPS[self.op](lv, rv)


class _BoolOp:
    def __init__(self, op, children):
        self.op, self.children = op, children

    def eval(self, obj) -> bool:
        if self.op == "&&":
            return all(c.eval(obj) for c in self.children)
        return any(c.eval(obj) for c in self.children)


class _Parser:
    def __init__(self, tokens: List[Tuple[str, Any]]):
        self.tokens = tokens
        self.pos = 0

    def peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self):
        tok = self.peek()
        if tok is None:
            raise XDRQueryError("unexpected end of query")
        self.pos += 1
        return tok

    def expect_op(self, op: str) -> None:
        tok = self.next()
        if tok != ("op", op):
            raise XDRQueryError(f"expected '{op}'")

    def parse_expr(self):
        node = self.parse_and()
        children = [node]
        while self.peek() == ("op", "||"):
            self.next()
            children.append(self.parse_and())
        return children[0] if len(children) == 1 else _BoolOp("||", children)

    def parse_and(self):
        node = self.parse_primary()
        children = [node]
        while self.peek() == ("op", "&&"):
            self.next()
            children.append(self.parse_primary())
        return children[0] if len(children) == 1 else _BoolOp("&&", children)

    def parse_primary(self):
        if self.peek() == ("op", "("):
            self.next()
            node = self.parse_expr()
            self.expect_op(")")
            return node
        return self.parse_comparison()

    def parse_operand(self):
        kind, v = self.next()
        if kind in ("int", "str", "path", "null"):
            return (kind, v)
        raise XDRQueryError(f"unexpected token {v!r}")

    def parse_comparison(self):
        left = self.parse_operand()
        tok = self.next()
        if tok[0] != "op" or tok[1] not in _Comparison._OPS:
            raise XDRQueryError("expected comparison operator")
        right = self.parse_operand()
        return _Comparison(left, tok[1], right)


class XDRMatcher:
    """Match XDR messages against a boolean query
    (reference: XDRQuery.h:36-66)."""

    def __init__(self, query: str):
        self.query = query
        self._root = None

    def match_xdr(self, obj: Any) -> bool:
        if self._root is None:
            parser = _Parser(_tokenize(self.query))
            root = parser.parse_expr()
            if parser.peek() is not None:
                raise XDRQueryError("trailing tokens in query")
            if isinstance(root, _Comparison) or isinstance(root, _BoolOp):
                self._root = root
            else:
                raise XDRQueryError("the query doesn't evaluate to bool")
        return self._root.eval(obj)


class XDRFieldExtractor:
    """Extract comma-separated leaf fields
    (reference: XDRQuery.h:68-100)."""

    def __init__(self, query: str):
        self.paths: List[List[str]] = []
        for part in query.split(","):
            part = part.strip()
            if not part:
                raise XDRQueryError("empty field in extractor query")
            toks = _tokenize(part)
            if len(toks) != 1 or toks[0][0] != "path":
                raise XDRQueryError(f"not a field path: '{part}'")
            self.paths.append(toks[0][1])
        self._validated = False

    def field_names(self) -> List[str]:
        return [".".join(p) for p in self.paths]

    def extract_fields(self, obj: Any) -> List[Any]:
        if not self._validated:
            for p in self.paths:
                validate_path(type(obj), p)
            self._validated = True
        out = []
        for p in self.paths:
            v, _ = resolve_field(obj, p)
            out.append(None if v is MISSING or v is NULL else v)
        return out


# ---------------------------------------------------------------------------
# Accumulators (reference: XDRQueryEval.h:163-200 — sum/avg/count)
# ---------------------------------------------------------------------------

_AGG_RE = re.compile(
    r"\s*(sum|avg|count)\s*\(\s*([A-Za-z_0-9.]*)\s*\)\s*$")


class XDRAccumulator:
    """Aggregate leaf fields over a stream of messages; the aggregate
    query is comma-separated `sum(path)` / `avg(path)` / `count()`."""

    def __init__(self, query: str):
        self.parts: List[Tuple[str, Optional[List[str]]]] = []
        for part in query.split(","):
            m = _AGG_RE.match(part)
            if m is None:
                raise XDRQueryError(f"bad accumulator: '{part.strip()}'")
            op, path = m.group(1), m.group(2)
            if op == "count":
                if path:
                    raise XDRQueryError("count() takes no field")
                self.parts.append((op, None))
            else:
                if not path:
                    raise XDRQueryError(f"{op}() needs a field")
                self.parts.append((op, path.split(".")))
        self._sums = [0] * len(self.parts)
        self._counts = [0] * len(self.parts)

    def add_entry(self, obj: Any) -> None:
        for i, (op, path) in enumerate(self.parts):
            if op == "count":
                self._counts[i] += 1
                continue
            v, t = resolve_field(obj, path)
            if v is MISSING or v is NULL:
                continue
            if not isinstance(v, (int, bool)) or isinstance(v, bool):
                raise XDRQueryError(
                    f"{op}({'.'.join(path)}) needs an integer field")
            self._sums[i] += v
            self._counts[i] += 1

    def get_values(self) -> "dict[str, Any]":
        out: "dict[str, Any]" = {}
        for i, (op, path) in enumerate(self.parts):
            if op == "count":
                out["count"] = self._counts[i]
            elif op == "sum":
                out[f"sum({'.'.join(path)})"] = self._sums[i]
            else:
                avg = (self._sums[i] / self._counts[i]
                       if self._counts[i] else 0.0)
                out[f"avg({'.'.join(path)})"] = avg
        return out
