"""Minimal ctypes binding to libpq (the native PostgreSQL client).

The reference links soci's postgresql backend over libpq
(database/Database.h:87-195, lib/soci); this build binds libpq.so
directly — no Python database-adapter dependency.  Everything goes through
PQexecParams with binary parameter/result formats, so BYTEA keys and
BIGINT columns round-trip without text escaping.

Only the call surface the Database facade needs is bound; errors raise
PostgresError with the server message.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Any, List, Optional, Sequence, Tuple

# result status codes (libpq-fe.h)
PGRES_EMPTY_QUERY = 0
PGRES_COMMAND_OK = 1
PGRES_TUPLES_OK = 2
CONNECTION_OK = 0

# type OIDs (pg_type.h)
OID_BOOL = 16
OID_BYTEA = 17
OID_INT8 = 20
OID_INT2 = 21
OID_INT4 = 23
OID_TEXT = 25
OID_FLOAT4 = 700
OID_FLOAT8 = 701
OID_VARCHAR = 1043


class PostgresError(Exception):
    pass


_lib = None


def load_libpq():
    """Load libpq.so once; raises PostgresError when absent."""
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("pq") or "libpq.so.5"
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        raise PostgresError(f"libpq not available: {e}")
    lib.PQconnectdb.restype = ctypes.c_void_p
    lib.PQconnectdb.argtypes = [ctypes.c_char_p]
    lib.PQstatus.restype = ctypes.c_int
    lib.PQstatus.argtypes = [ctypes.c_void_p]
    lib.PQerrorMessage.restype = ctypes.c_char_p
    lib.PQerrorMessage.argtypes = [ctypes.c_void_p]
    lib.PQfinish.restype = None
    lib.PQfinish.argtypes = [ctypes.c_void_p]
    lib.PQexecParams.restype = ctypes.c_void_p
    lib.PQexecParams.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint),            # paramTypes
        ctypes.POINTER(ctypes.c_char_p),          # paramValues
        ctypes.POINTER(ctypes.c_int),             # paramLengths
        ctypes.POINTER(ctypes.c_int),             # paramFormats
        ctypes.c_int]                             # resultFormat
    lib.PQresultStatus.restype = ctypes.c_int
    lib.PQresultStatus.argtypes = [ctypes.c_void_p]
    lib.PQresultErrorMessage.restype = ctypes.c_char_p
    lib.PQresultErrorMessage.argtypes = [ctypes.c_void_p]
    lib.PQclear.restype = None
    lib.PQclear.argtypes = [ctypes.c_void_p]
    lib.PQntuples.restype = ctypes.c_int
    lib.PQntuples.argtypes = [ctypes.c_void_p]
    lib.PQnfields.restype = ctypes.c_int
    lib.PQnfields.argtypes = [ctypes.c_void_p]
    lib.PQftype.restype = ctypes.c_uint
    lib.PQftype.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.PQgetvalue.restype = ctypes.POINTER(ctypes.c_char)
    lib.PQgetvalue.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int]
    lib.PQgetlength.restype = ctypes.c_int
    lib.PQgetlength.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int]
    lib.PQgetisnull.restype = ctypes.c_int
    lib.PQgetisnull.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int]
    lib.PQprepare.restype = ctypes.c_void_p
    lib.PQprepare.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_char_p, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_uint)]
    lib.PQexecPrepared.restype = ctypes.c_void_p
    lib.PQexecPrepared.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    _lib = lib
    return lib


def _encode_param(v: Any) -> Tuple[int, Optional[bytes], int]:
    """→ (oid, wire bytes (binary format), format flag)."""
    if v is None:
        return (0, None, 1)
    if isinstance(v, bool):
        return (OID_BOOL, b"\x01" if v else b"\x00", 1)
    if isinstance(v, int):
        return (OID_INT8, v.to_bytes(8, "big", signed=True), 1)
    if isinstance(v, float):
        import struct
        return (OID_FLOAT8, struct.pack(">d", v), 1)
    if isinstance(v, (bytes, bytearray, memoryview)):
        return (OID_BYTEA, bytes(v), 1)
    if isinstance(v, str):
        return (OID_TEXT, v.encode("utf-8"), 1)
    raise PostgresError(f"unsupported parameter type {type(v)!r}")


def _decode_field(oid: int, raw: bytes) -> Any:
    if oid == OID_BYTEA:
        return raw
    if oid in (OID_INT8, OID_INT4, OID_INT2):
        return int.from_bytes(raw, "big", signed=True)
    if oid == OID_BOOL:
        return raw != b"\x00"
    if oid == OID_FLOAT8:
        import struct
        return struct.unpack(">d", raw)[0]
    if oid == OID_FLOAT4:
        import struct
        return struct.unpack(">f", raw)[0]
    if oid in (OID_TEXT, OID_VARCHAR):
        return raw.decode("utf-8")
    return raw                      # unknown: raw binary


class PGConnection:
    """One libpq connection; not thread-safe (callers hold a lock)."""

    def __init__(self, conninfo: str):
        self._lib = load_libpq()
        self._conn = self._lib.PQconnectdb(conninfo.encode())
        if not self._conn or \
                self._lib.PQstatus(self._conn) != CONNECTION_OK:
            msg = self._lib.PQerrorMessage(self._conn) or b""
            err = msg.decode("utf-8", "replace").strip()
            if self._conn:
                self._lib.PQfinish(self._conn)
                self._conn = None
            raise PostgresError(f"connection failed: {err}")

    def close(self) -> None:
        if self._conn:
            self._lib.PQfinish(self._conn)
            self._conn = None

    def prepare(self, name: str, sql: str, nparams: int,
                sample_params: Optional[Sequence[Any]] = None,
                oids: Optional[Sequence[int]] = None) -> None:
        """Server-side prepared statement. When `oids` (or
        `sample_params`, from which OIDs are derived) is given, the
        types are declared in the Parse message — a real postgres
        infers types from context either way, but declaring them lets
        wire-level test doubles (db/pg_stub.py) decode binary
        parameters without guessing."""
        lib = self._lib
        types = None
        if oids is None and sample_params is not None \
                and len(sample_params) == nparams:
            # OID 0 at a NULL sample's position = "server infers this
            # one"; the rest stay declared (Parse supports per-element 0)
            oids = [_encode_param(v)[0] for v in sample_params]
        if oids is not None and len(oids) == nparams and any(oids):
            types = (ctypes.c_uint * nparams)(*oids)
        res = lib.PQprepare(self._conn, name.encode(), sql.encode(),
                            nparams, types)
        try:
            if lib.PQresultStatus(res) != PGRES_COMMAND_OK:
                msg = (lib.PQresultErrorMessage(res) or b"").decode(
                    "utf-8", "replace").strip()
                raise PostgresError(f"prepare failed: {msg}\nSQL: {sql}")
        finally:
            lib.PQclear(res)

    def exec_prepared(self, name: str,
                      params: Sequence[Any] = ()) -> Optional[List[tuple]]:
        lib = self._lib
        n = len(params)
        encoded = [_encode_param(v) for v in params]
        vals = (ctypes.c_char_p * n)(
            *[e[1] if e[1] is not None else None for e in encoded])
        lens = (ctypes.c_int * n)(
            *[len(e[1]) if e[1] is not None else 0 for e in encoded])
        fmts = (ctypes.c_int * n)(*[e[2] for e in encoded])
        res = lib.PQexecPrepared(self._conn, name.encode(), n,
                                 vals, lens, fmts, 1)
        return self._consume(res, name)

    def exec(self, sql: str,
             params: Sequence[Any] = ()) -> Optional[List[tuple]]:
        """Run one statement; returns rows for TUPLES results, None for
        commands.  All params and results use the binary format."""
        lib = self._lib
        n = len(params)
        encoded = [_encode_param(v) for v in params]
        oids = (ctypes.c_uint * n)(*[e[0] for e in encoded])
        vals = (ctypes.c_char_p * n)(
            *[e[1] if e[1] is not None else None for e in encoded])
        lens = (ctypes.c_int * n)(
            *[len(e[1]) if e[1] is not None else 0 for e in encoded])
        fmts = (ctypes.c_int * n)(*[e[2] for e in encoded])
        res = lib.PQexecParams(self._conn, sql.encode(), n,
                               oids, vals, lens, fmts, 1)
        return self._consume(res, sql)

    def _consume(self, res, sql: str) -> Optional[List[tuple]]:
        lib = self._lib
        try:
            status = lib.PQresultStatus(res)
            if status == PGRES_COMMAND_OK:
                return None
            if status != PGRES_TUPLES_OK:
                msg = (lib.PQresultErrorMessage(res) or b"").decode(
                    "utf-8", "replace").strip()
                raise PostgresError(f"{msg or 'query failed'}\nSQL: {sql}")
            nrows = lib.PQntuples(res)
            ncols = lib.PQnfields(res)
            col_oids = [lib.PQftype(res, c) for c in range(ncols)]
            out = []
            for r in range(nrows):
                row = []
                for c in range(ncols):
                    if lib.PQgetisnull(res, r, c):
                        row.append(None)
                        continue
                    ln = lib.PQgetlength(res, r, c)
                    ptr = lib.PQgetvalue(res, r, c)
                    raw = ctypes.string_at(ptr, ln)
                    row.append(_decode_field(col_oids[c], raw))
                out.append(tuple(row))
            return out
        finally:
            lib.PQclear(res)
