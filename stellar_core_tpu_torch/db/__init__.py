"""SQL persistence layer (reference: src/database/, soci + sqlite/postgres).

This build uses the stdlib sqlite3 C module as the storage engine; the
`Database` facade keeps the reference's shape: session + statement cache,
schema versioning with stepwise upgrades, and a transaction scope that the
ledger commit path wraps around a whole ledger close
(database/Database.h:87, docs/db-schema.md).
"""

from .database import Database, SCHEMA_VERSION

__all__ = ["Database", "SCHEMA_VERSION"]
