"""Overlay p2p message types (reference: Stellar-overlay.x; dispatch table in
overlay/Peer.cpp:519-585)."""

from __future__ import annotations

from enum import IntEnum

from .runtime import (
    Array, Int32, Int64, Opaque, Struct, Uint32, Uint64, Union, VarArray,
    VarOpaque, XdrString,
)
from .types import (
    Curve25519Public, Hash, HmacSha256Mac, NodeID, PublicKey, Signature,
    Uint256,
)
from .ledger import GeneralizedTransactionSet, TransactionSet
from .transaction import TransactionEnvelope
from .scp import SCPEnvelope, SCPQuorumSet

MAX_TX_ADVERT_VECTOR = 1000
MAX_TX_DEMAND_VECTOR = 1000
TX_ADVERT_VECTOR = VarArray(Hash, MAX_TX_ADVERT_VECTOR)
TX_DEMAND_VECTOR = VarArray(Hash, MAX_TX_DEMAND_VECTOR)


class ErrorCode(IntEnum):
    ERR_MISC = 0
    ERR_DATA = 1
    ERR_CONF = 2
    ERR_AUTH = 3
    ERR_LOAD = 4


class Error(Struct):
    FIELDS = [("code", ErrorCode), ("msg", XdrString(100))]


class SendMore(Struct):
    FIELDS = [("numMessages", Uint32)]


class SendMoreExtended(Struct):
    FIELDS = [("numMessages", Uint32), ("numBytes", Uint32)]


class AuthCert(Struct):
    """Short-lived X25519 session pubkey signed by the node's Ed25519 identity
    (reference: overlay/PeerAuth.h:17-42)."""
    FIELDS = [
        ("pubkey", Curve25519Public),
        ("expiration", Uint64),
        ("sig", Signature),
    ]


class Hello(Struct):
    FIELDS = [
        ("ledgerVersion", Uint32),
        ("overlayVersion", Uint32),
        ("overlayMinVersion", Uint32),
        ("networkID", Hash),
        ("versionStr", XdrString(100)),
        ("listeningPort", Int32),
        ("peerID", NodeID),
        ("cert", AuthCert),
        ("nonce", Uint256),
    ]


AUTH_MSG_FLAG_FLOW_CONTROL_BYTES_REQUESTED = 200


class Auth(Struct):
    FIELDS = [("flags", Int32)]


class IPAddrType(IntEnum):
    IPv4 = 0
    IPv6 = 1


class _PeerAddressIp(Union):
    SWITCH = IPAddrType
    ARMS = {
        IPAddrType.IPv4: ("ipv4", Opaque(4)),
        IPAddrType.IPv6: ("ipv6", Opaque(16)),
    }


class PeerAddress(Struct):
    FIELDS = [
        ("ip", _PeerAddressIp),
        ("port", Uint32),
        ("numFailures", Uint32),
    ]


class MessageType(IntEnum):
    ERROR_MSG = 0
    AUTH = 2
    DONT_HAVE = 3
    GET_PEERS = 4
    PEERS = 5
    GET_TX_SET = 6
    TX_SET = 7
    GENERALIZED_TX_SET = 17
    TRANSACTION = 8
    GET_SCP_QUORUMSET = 9
    SCP_QUORUMSET = 10
    SCP_MESSAGE = 11
    GET_SCP_STATE = 12
    HELLO = 13
    SURVEY_REQUEST = 14
    SURVEY_RESPONSE = 15
    SEND_MORE = 16
    SEND_MORE_EXTENDED = 20
    FLOOD_ADVERT = 18
    FLOOD_DEMAND = 19


class DontHave(Struct):
    FIELDS = [("type", Int32), ("reqHash", Uint256)]


class SurveyMessageCommandType(IntEnum):
    SURVEY_TOPOLOGY = 0


class SurveyRequestMessage(Struct):
    FIELDS = [
        ("surveyorPeerID", NodeID),
        ("surveyedPeerID", NodeID),
        ("ledgerNum", Uint32),
        ("encryptionKey", Curve25519Public),
        ("commandType", SurveyMessageCommandType),
    ]


class SignedSurveyRequestMessage(Struct):
    FIELDS = [
        ("requestSignature", Signature),
        ("request", SurveyRequestMessage),
    ]


EncryptedBody = VarOpaque(64000)


class SurveyResponseMessage(Struct):
    FIELDS = [
        ("surveyorPeerID", NodeID),
        ("surveyedPeerID", NodeID),
        ("ledgerNum", Uint32),
        ("commandType", SurveyMessageCommandType),
        ("encryptedBody", EncryptedBody),
    ]


class SignedSurveyResponseMessage(Struct):
    FIELDS = [
        ("responseSignature", Signature),
        ("response", SurveyResponseMessage),
    ]


class PeerStats(Struct):
    FIELDS = [
        ("id", NodeID),
        ("versionStr", XdrString(100)),
        ("messagesRead", Uint64),
        ("messagesWritten", Uint64),
        ("bytesRead", Uint64),
        ("bytesWritten", Uint64),
        ("secondsConnected", Uint64),
        ("uniqueFloodBytesRecv", Uint64),
        ("duplicateFloodBytesRecv", Uint64),
        ("uniqueFetchBytesRecv", Uint64),
        ("duplicateFetchBytesRecv", Uint64),
        ("uniqueFloodMessageRecv", Uint64),
        ("duplicateFloodMessageRecv", Uint64),
        ("uniqueFetchMessageRecv", Uint64),
        ("duplicateFetchMessageRecv", Uint64),
    ]


class TopologyResponseBody(Struct):
    FIELDS = [
        ("inboundPeers", VarArray(PeerStats, 25)),
        ("outboundPeers", VarArray(PeerStats, 25)),
        ("totalInboundPeerCount", Uint32),
        ("totalOutboundPeerCount", Uint32),
    ]


class SurveyResponseBody(Union):
    SWITCH = SurveyMessageCommandType
    ARMS = {
        SurveyMessageCommandType.SURVEY_TOPOLOGY:
            ("topologyResponseBody", TopologyResponseBody),
    }


class FloodAdvert(Struct):
    FIELDS = [("txHashes", TX_ADVERT_VECTOR)]


class FloodDemand(Struct):
    FIELDS = [("txHashes", TX_DEMAND_VECTOR)]


class StellarMessage(Union):
    SWITCH = MessageType
    ARMS = {
        MessageType.ERROR_MSG: ("error", Error),
        MessageType.HELLO: ("hello", Hello),
        MessageType.AUTH: ("auth", Auth),
        MessageType.DONT_HAVE: ("dontHave", DontHave),
        MessageType.GET_PEERS: None,
        MessageType.PEERS: ("peers", VarArray(PeerAddress, 100)),
        MessageType.GET_TX_SET: ("txSetHash", Uint256),
        MessageType.TX_SET: ("txSet", TransactionSet),
        MessageType.GENERALIZED_TX_SET:
            ("generalizedTxSet", GeneralizedTransactionSet),
        MessageType.TRANSACTION: ("transaction", TransactionEnvelope),
        MessageType.SURVEY_REQUEST:
            ("signedSurveyRequestMessage", SignedSurveyRequestMessage),
        MessageType.SURVEY_RESPONSE:
            ("signedSurveyResponseMessage", SignedSurveyResponseMessage),
        MessageType.GET_SCP_QUORUMSET: ("qSetHash", Uint256),
        MessageType.SCP_QUORUMSET: ("qSet", SCPQuorumSet),
        MessageType.SCP_MESSAGE: ("envelope", SCPEnvelope),
        MessageType.GET_SCP_STATE: ("getSCPLedgerSeq", Uint32),
        MessageType.SEND_MORE: ("sendMoreMessage", SendMore),
        MessageType.SEND_MORE_EXTENDED:
            ("sendMoreExtendedMessage", SendMoreExtended),
        MessageType.FLOOD_ADVERT: ("floodAdvert", FloodAdvert),
        MessageType.FLOOD_DEMAND: ("floodDemand", FloodDemand),
    }


class _AuthenticatedMessageV0(Struct):
    FIELDS = [
        ("sequence", Uint64),
        ("message", StellarMessage),
        ("mac", HmacSha256Mac),
    ]


class AuthenticatedMessage(Union):
    SWITCH = Uint32
    ARMS = {0: ("v0", _AuthenticatedMessageV0)}
