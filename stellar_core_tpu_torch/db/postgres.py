"""PostgreSQL Database backend over the ctypes libpq binding.

Reference: the soci postgresql session (database/Database.h:87-195,
Database.cpp:208-265 — dual-backend with postgres-specific operations).
This backend exposes the exact facade `Database` (sqlite) exposes, so
LedgerTxnRoot, the managers, and the admin routes run unchanged; the
node selects it with DATABASE="postgresql://..." (db/database.py
create_database).

Dialect seam: the node authors SQL in the canonical sqlite dialect;
`translate()` mechanically rewrites
  - `?` placeholders → `$1..$n`
  - sqlite upserts (`OR REPLACE`) → `INSERT ... ON CONFLICT (pk)
    DO UPDATE SET col=EXCLUDED.col, ...` (pk from TABLE_CONFLICT_KEYS),
    with a pre-DELETE on any secondary unique columns
    (TABLE_SECONDARY_UNIQUES) because sqlite's OR REPLACE evicts rows
    conflicting on ANY unique index, not just the primary one
  - DDL types BLOB/INTEGER/REAL → BYTEA/BIGINT/DOUBLE PRECISION
  - `PRAGMA ...` → no-op

Write batching (postgres-specific operations, the reference's
Database.h:87-195 seam): `executemany` expands INSERT upserts into
multi-row VALUES statements (one round trip per ~120 rows) and runs
everything else through named prepared statements (parse once per
connection).
"""

from __future__ import annotations

import re
import threading
from typing import Any, Iterable, List, Optional, Tuple

from ..util.logging import get_logger
from .database import (SchemaMixin, TABLE_CONFLICT_KEYS,
                       TABLE_SECONDARY_UNIQUES)
from .libpq import PGConnection, PostgresError

log = get_logger("Database")

_INSERT_OR_REPLACE = re.compile(
    r"^\s*INSERT\s+OR\s+REPLACE\s+INTO\s+(\w+)\s*\(([^)]*)\)\s*(.*)$",
    re.IGNORECASE | re.DOTALL)
_VALUES = re.compile(r"VALUES\s*\(([^)]*)\)\s*", re.IGNORECASE)


class Translated:
    """One sqlite statement translated for postgres.

    sql: the main statement ($n placeholders); None = no-op.
    pre_deletes: [(delete_sql, param_indices)] to run BEFORE the main
    statement with the listed 0-based parameter positions (secondary
    unique emulation).
    """

    __slots__ = ("sql", "pre_deletes", "n_params")

    def __init__(self, sql: Optional[str], pre_deletes=(), n_params=0):
        self.sql = sql
        self.pre_deletes = list(pre_deletes)
        self.n_params = n_params


def translate(sql: str) -> Translated:
    """sqlite-dialect → postgres-dialect."""
    s = sql.strip()
    if s.upper().startswith("PRAGMA"):
        return Translated(None)
    pre_deletes: List[Tuple[str, Tuple[int, ...]]] = []
    m = _INSERT_OR_REPLACE.match(s)
    if m:
        table, cols, rest = m.group(1).lower(), m.group(2), m.group(3)
        keys = TABLE_CONFLICT_KEYS.get(table)
        if keys is None:
            raise PostgresError(
                f"no conflict key known for table {table}")
        col_names = [c.strip().lower() for c in cols.split(",")]
        updates = ", ".join(f"{c}=EXCLUDED.{c}" for c in col_names
                            if c not in keys)
        conflict = ", ".join(keys)
        action = f"DO UPDATE SET {updates}" if updates else "DO NOTHING"
        s = (f"INSERT INTO {table} ({cols}) {rest} "
             f"ON CONFLICT ({conflict}) {action}")
        # sqlite OR REPLACE also evicts rows conflicting on secondary
        # unique indexes; emulate with targeted pre-deletes
        for col in TABLE_SECONDARY_UNIQUES.get(table, ()):
            if col in col_names:
                pre_deletes.append(
                    (f"DELETE FROM {table} WHERE {col}=$1 "
                     f"AND NOT ({' AND '.join(f'{k}=${i + 2}' for i, k in enumerate(keys))})",
                     (col_names.index(col),
                      *[col_names.index(k) for k in keys])))
    if s.upper().startswith("CREATE "):
        s = re.sub(r"\bBLOB\b", "BYTEA", s)
        s = re.sub(r"\bINTEGER\b", "BIGINT", s)
        s = re.sub(r"\bREAL\b", "DOUBLE PRECISION", s)
    out = []
    n = 0
    for ch in s:
        if ch == "?":
            n += 1
            out.append(f"${n}")
        else:
            out.append(ch)
    return Translated("".join(out), pre_deletes, n)


class _Rows(list):
    """query result with sqlite-cursor-compatible helpers."""

    def fetchone(self):
        return self[0] if self else None

    def fetchall(self):
        return list(self)


class PostgresDatabase(SchemaMixin):
    """Same facade as db.database.Database, postgres-backed."""

    _missing_table_errors = (PostgresError,)

    def __init__(self, conninfo: str, metrics=None):
        self.path = conninfo
        self._conn = PGConnection(conninfo)
        self._lock = threading.RLock()
        self._tx_depth = 0
        self._metrics = metrics
        self._query_meter = (metrics.meter("database", "query", "exec")
                             if metrics else None)
        self._prepared: dict = {}        # translated sql -> [name, sample]
        self._stmt_seq = 0               # unique server-side stmt names

    # ---------------------------------------------------------------- core --
    def _run(self, t: Translated, params: tuple):
        for dsql, idxs in t.pre_deletes:
            self._conn.exec(dsql, tuple(params[i] for i in idxs))
        return self._conn.exec(t.sql, params)

    def execute(self, sql: str, params: Iterable[Any] = ()) -> _Rows:
        self._completion_barrier(sql)
        t = translate(sql)
        if t.sql is None:
            return _Rows()
        with self._lock:
            if self._query_meter:
                self._query_meter.mark()
            rows = self._run(t, tuple(params))
        return _Rows(rows or [])

    def executemany(self, sql: str, rows: Iterable[Iterable[Any]]) -> None:
        self._completion_barrier(sql)
        rows = [tuple(r) for r in rows]
        if not rows:
            return
        t = translate(sql)
        if t.sql is None:
            return
        with self._lock:
            if self._query_meter:
                self._query_meter.mark(len(rows))
            vm = _VALUES.search(t.sql)
            if vm and not t.sql[vm.end():].strip().upper().startswith(
                    "SELECT"):
                self._execmany_values(t, vm, rows)
            else:
                name = self._prepare_batch(t.sql, rows)
                for r in rows:
                    for dsql, idxs in t.pre_deletes:
                        self._conn.exec(dsql,
                                        tuple(r[i] for i in idxs))
                    self._conn.exec_prepared(name, r)

    def _execmany_values(self, t: Translated, vm, rows) -> None:
        """Multi-row VALUES expansion: one round trip per chunk."""
        ncols = len(rows[0])
        # secondary-unique pre-deletes, batched as one IN (...) query
        for dsql_single, idxs in t.pre_deletes:
            col = dsql_single.split("WHERE ", 1)[1].split("=", 1)[0]
            table = dsql_single.split("DELETE FROM ", 1)[1].split()[0]
            vals = [r[idxs[0]] for r in rows]
            for i in range(0, len(vals), 500):
                chunk = vals[i:i + 500]
                marks = ",".join(f"${j + 1}" for j in range(len(chunk)))
                self._conn.exec(
                    f"DELETE FROM {table} WHERE {col} IN ({marks})",
                    tuple(chunk))
        head = t.sql[:vm.start()]
        tail = t.sql[vm.end():]
        max_rows = max(1, 960 // ncols)
        for i in range(0, len(rows), max_rows):
            chunk = rows[i:i + max_rows]
            groups = []
            for r_i in range(len(chunk)):
                base = r_i * ncols
                groups.append("(" + ",".join(
                    f"${base + c + 1}" for c in range(ncols)) + ")")
            sql = f"{head}VALUES {', '.join(groups)} {tail}"
            flat = tuple(v for r in chunk for v in r)
            self._conn.exec(sql, flat)

    def _prepare_batch(self, sql: str, rows) -> str:
        """Prepared-statement name for an executemany batch.

        Per-position sample = first non-NULL value in any row, so a
        NULL in row 0 doesn't leave that position's OID undeclared for
        the rows that do carry a value. A position that was NULL in
        EVERY row of the first batch stays undeclared (Parse OID 0) —
        harmless while only NULLs bind there, but a later batch that
        carries a real value there would have the wire-level test
        double guessing its type (db/pg_stub.py) — so when a better
        sample appears, re-prepare under a fresh name instead of
        reusing the cached statement forever. Fully-typed statements
        (the common case) skip the sample scan entirely on cache hits."""
        from .libpq import _encode_param
        nparams = len(rows[0])

        def position_oid(j):
            v = next((r[j] for r in rows if r[j] is not None), None)
            return 0 if v is None else _encode_param(v)[0]

        entry = self._prepared.get(sql)   # sql -> [name, oid tuple]
        if entry is not None:
            name, cached_oids = entry
            holes = [j for j, o in enumerate(cached_oids) if o == 0]
            if not holes:
                return name
            merged = list(cached_oids)
            improved = False
            for j in holes:
                o = position_oid(j)
                if o:
                    merged[j] = o
                    improved = True
            if not improved:
                return name
            new_name = self._next_stmt_name()
            self._conn.prepare(new_name, sql, nparams, oids=tuple(merged))
            # the superseded statement would otherwise sit in postgres
            # session memory for the connection's lifetime
            self._conn.exec(f"DEALLOCATE {name}")
            self._prepared[sql] = [new_name, tuple(merged)]
            return new_name
        oids = tuple(position_oid(j) for j in range(nparams))
        name = self._next_stmt_name()
        self._conn.prepare(name, sql, nparams, oids=oids)
        self._prepared[sql] = [name, oids]
        return name

    def _next_stmt_name(self) -> str:
        self._stmt_seq += 1
        return f"ps{self._stmt_seq}"

    # -------------------------------------------------------- transactions --
    class _TxScope:
        """Same lock-for-the-whole-scope semantics as the sqlite
        backend: the close-completion worker shares this connection."""

        def __init__(self, db: "PostgresDatabase"):
            self._db = db

        def __enter__(self):
            db = self._db
            db._lock.acquire()
            try:
                if db._tx_depth == 0:
                    db._conn.exec("BEGIN")
                    db._tx_owner = threading.current_thread()
                else:
                    db._conn.exec(f"SAVEPOINT sp{db._tx_depth}")
                db._tx_depth += 1
            except BaseException:
                db._lock.release()
                raise
            return self

        def __exit__(self, exc_type, exc, tb):
            db = self._db
            try:
                db._tx_depth -= 1
                if exc_type is None:
                    if db._tx_depth == 0:
                        db._conn.exec("COMMIT")
                    else:
                        db._conn.exec(f"RELEASE sp{db._tx_depth}")
                else:
                    if db._tx_depth == 0:
                        db._conn.exec("ROLLBACK")
                    else:
                        db._conn.exec(f"ROLLBACK TO sp{db._tx_depth}")
                        db._conn.exec(f"RELEASE sp{db._tx_depth}")
            finally:
                # even if COMMIT/ROLLBACK itself raised: an outermost
                # scope is over either way, and a stale owner would let
                # this thread bypass the completion barrier forever
                if db._tx_depth == 0:
                    db._tx_owner = None
                db._lock.release()
            return False

    def transaction(self) -> "_TxScope":
        return PostgresDatabase._TxScope(self)

    # ---------------------------------------------------------------- misc --
    def close(self) -> None:
        with self._lock:
            self._conn.close()
