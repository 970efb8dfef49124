"""XDR protocol layer — canonical wire/hash/history format.

Reference: src/protocol-curr/xdr compiled by xdrpp (src/Makefile.am:46-51);
"single, standard XDR for canonical (hashed) format, history, and inter-node
messaging" (docs/architecture.md:50-52).
"""

from .runtime import (  # noqa: F401
    Array, Bool, Int32, Int64, Lazy, Opaque, Optional, Reader, Struct,
    Uint32, Uint64, Union, VarArray, VarOpaque, Writer, XdrError, XdrString,
    xdr_from_bytes, xdr_to_bytes,
)
from . import (types, ledger_entries, contract, transaction, results,
               ledger, scp, overlay)  # noqa: F401
# `contract` must load with the package: importing it joins the Soroban
# arms (CONTRACT_DATA/CONTRACT_CODE/CONFIG_SETTING/TTL) into LedgerKey
# and LedgerEntry's unions


def xdr_sha256(value) -> bytes:
    """SHA256 of the canonical XDR encoding — the ubiquitous object hash
    (reference: crypto/XDRHasher.h, xdrSha256 in crypto/SHA.h)."""
    import hashlib

    return hashlib.sha256(value.to_bytes()).digest()
