"""SCP consensus message types (reference: Stellar-SCP.x; consumed by
src/scp — the freestanding consensus kernel, scp/readme.md:3-12)."""

from __future__ import annotations

from enum import IntEnum

from .runtime import (
    Int32, Lazy, Optional, Struct, Uint32, Uint64, Union, VarArray, VarOpaque,
)
from .types import Hash, NodeID, Signature

Value = VarOpaque()


class SCPBallot(Struct):
    FIELDS = [("counter", Uint32), ("value", Value)]


class SCPStatementType(IntEnum):
    SCP_ST_PREPARE = 0
    SCP_ST_CONFIRM = 1
    SCP_ST_EXTERNALIZE = 2
    SCP_ST_NOMINATE = 3


class SCPNomination(Struct):
    FIELDS = [
        ("quorumSetHash", Hash),
        ("votes", VarArray(Value)),
        ("accepted", VarArray(Value)),
    ]


class SCPStatementPrepare(Struct):
    FIELDS = [
        ("quorumSetHash", Hash),
        ("ballot", SCPBallot),
        ("prepared", Optional(SCPBallot)),
        ("preparedPrime", Optional(SCPBallot)),
        ("nC", Uint32),
        ("nH", Uint32),
    ]


class SCPStatementConfirm(Struct):
    FIELDS = [
        ("ballot", SCPBallot),
        ("nPrepared", Uint32),
        ("nCommit", Uint32),
        ("nH", Uint32),
        ("quorumSetHash", Hash),
    ]


class SCPStatementExternalize(Struct):
    FIELDS = [
        ("commit", SCPBallot),
        ("nH", Uint32),
        ("commitQuorumSetHash", Hash),
    ]


class _SCPStatementPledges(Union):
    SWITCH = SCPStatementType
    ARMS = {
        SCPStatementType.SCP_ST_PREPARE: ("prepare", SCPStatementPrepare),
        SCPStatementType.SCP_ST_CONFIRM: ("confirm", SCPStatementConfirm),
        SCPStatementType.SCP_ST_EXTERNALIZE:
            ("externalize", SCPStatementExternalize),
        SCPStatementType.SCP_ST_NOMINATE: ("nominate", SCPNomination),
    }


class SCPStatement(Struct):
    FIELDS = [
        ("nodeID", NodeID),
        ("slotIndex", Uint64),
        ("pledges", _SCPStatementPledges),
    ]


class SCPEnvelope(Struct):
    FIELDS = [("statement", SCPStatement), ("signature", Signature)]


class SCPQuorumSet(Struct):
    """Recursive quorum-set tree (reference: scp/LocalNode isQuorumSlice;
    sanity rules in scp/QuorumSetUtils.cpp)."""
    FIELDS = [
        ("threshold", Uint32),
        ("validators", VarArray(NodeID)),
        ("innerSets", VarArray(Lazy(lambda: SCPQuorumSet))),
    ]


class LedgerSCPMessages(Struct):
    """SCP messages externalizing one ledger (reference: Stellar-ledger.x
    LedgerSCPMessages; written by herder/HerderPersistence)."""
    FIELDS = [
        ("ledgerSeq", Uint32),
        ("messages", VarArray(SCPEnvelope)),
    ]


class SCPHistoryEntryV0(Struct):
    FIELDS = [
        ("quorumSets", VarArray(SCPQuorumSet)),
        ("ledgerMessages", LedgerSCPMessages),
    ]


class SCPHistoryEntry(Union):
    SWITCH = Int32
    ARMS = {0: ("v0", SCPHistoryEntryV0)}
