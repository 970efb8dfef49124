"""Base protocol types (reference: Stellar-types.x via xdrpp codegen;
usage cited throughout src/crypto and src/overlay)."""

from __future__ import annotations

from enum import IntEnum

from .runtime import (
    Array, Bool, Int32, Int64, Opaque, Optional, Struct, Uint32, Uint64,
    Union, VarArray, VarOpaque, XdrString,
)

# opaque[32] aliases
Hash = Opaque(32)
Uint256 = Opaque(32)

Signature = VarOpaque(64)
SignatureHint = Opaque(4)


class CryptoKeyType(IntEnum):
    KEY_TYPE_ED25519 = 0
    KEY_TYPE_PRE_AUTH_TX = 1
    KEY_TYPE_HASH_X = 2
    KEY_TYPE_ED25519_SIGNED_PAYLOAD = 3
    KEY_TYPE_MUXED_ED25519 = 0x100


class PublicKeyType(IntEnum):
    PUBLIC_KEY_TYPE_ED25519 = 0


class SignerKeyType(IntEnum):
    SIGNER_KEY_TYPE_ED25519 = 0
    SIGNER_KEY_TYPE_PRE_AUTH_TX = 1
    SIGNER_KEY_TYPE_HASH_X = 2
    SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD = 3


class PublicKey(Union):
    SWITCH = PublicKeyType
    ARMS = {PublicKeyType.PUBLIC_KEY_TYPE_ED25519: ("ed25519", Uint256)}

    @classmethod
    def ed25519(cls, raw: bytes) -> "PublicKey":
        return cls(PublicKeyType.PUBLIC_KEY_TYPE_ED25519, raw)


# NodeID and AccountID are PublicKey aliases in the reference XDR
NodeID = PublicKey
AccountID = PublicKey


class Ed25519SignedPayload(Struct):
    FIELDS = [("ed25519", Uint256), ("payload", VarOpaque(64))]


class SignerKey(Union):
    SWITCH = SignerKeyType
    ARMS = {
        SignerKeyType.SIGNER_KEY_TYPE_ED25519: ("ed25519", Uint256),
        SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX: ("preAuthTx", Uint256),
        SignerKeyType.SIGNER_KEY_TYPE_HASH_X: ("hashX", Uint256),
        SignerKeyType.SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD:
            ("ed25519SignedPayload", Ed25519SignedPayload),
    }


class Curve25519Secret(Struct):
    FIELDS = [("key", Opaque(32))]


class Curve25519Public(Struct):
    FIELDS = [("key", Opaque(32))]


class HmacSha256Key(Struct):
    FIELDS = [("key", Opaque(32))]


class HmacSha256Mac(Struct):
    FIELDS = [("mac", Opaque(32))]


class ExtensionPoint(Union):
    """Reserved extension point — only case 0 (void) exists."""
    SWITCH = Int32
    ARMS = {0: None}


class EnvelopeType(IntEnum):
    ENVELOPE_TYPE_TX_V0 = 0
    ENVELOPE_TYPE_SCP = 1
    ENVELOPE_TYPE_TX = 2
    ENVELOPE_TYPE_AUTH = 3
    ENVELOPE_TYPE_SCPVALUE = 4
    ENVELOPE_TYPE_TX_FEE_BUMP = 5
    ENVELOPE_TYPE_OP_ID = 6
    ENVELOPE_TYPE_POOL_REVOKE_OP_ID = 7
    ENVELOPE_TYPE_CONTRACT_ID = 8
    ENVELOPE_TYPE_SOROBAN_AUTHORIZATION = 9
