"""Per-connection authentication material.

Reference: src/overlay/PeerAuth.{h,cpp} — each node keeps one X25519
session keypair and an AuthCert: the session pubkey + expiration signed
by the long-lived Ed25519 node key over
SHA256(networkID ‖ ENVELOPE_TYPE_AUTH ‖ expiration ‖ pubkey). After
HELLO exchange, ECDH + HKDF derive one HMAC-SHA256 key per direction,
bound to both sides' nonces and the caller/callee roles.
"""

from __future__ import annotations

import struct
from enum import Enum
from typing import Dict, Tuple

from ..crypto.curve25519 import (Curve25519Public, Curve25519Secret,
                                 expand_session_key)
from ..crypto.keys import PubKeyUtils
from ..crypto.sha import sha256
from ..xdr.overlay import AuthCert
from ..xdr.types import Curve25519Public as XdrCurve25519Public
from ..xdr.types import EnvelopeType

# reference: PeerAuth.cpp expirationLimit — certs live an hour
CERT_EXPIRATION_SECONDS = 3600


class PeerRole(Enum):
    WE_CALLED_REMOTE = 0
    REMOTE_CALLED_US = 1


def _cert_hash(network_id: bytes, expiration: int, pubkey: bytes) -> bytes:
    # xdr_to_opaque(networkID, ENVELOPE_TYPE_AUTH, expiration, pubkey)
    return sha256(network_id
                  + struct.pack(">i", EnvelopeType.ENVELOPE_TYPE_AUTH)
                  + struct.pack(">Q", expiration) + pubkey)


class PeerAuth:
    def __init__(self, config, now_fn):
        self.config = config
        self.network_id = config.network_id()
        self._now = now_fn
        self._secret = Curve25519Secret.random()
        self._public = self._secret.derive_public()
        self._cert = self._make_cert()
        self._shared_cache: Dict[Tuple[bytes, PeerRole], bytes] = {}

    def _make_cert(self) -> AuthCert:
        expiration = int(self._now()) + CERT_EXPIRATION_SECONDS
        h = _cert_hash(self.network_id, expiration, self._public.key)
        return AuthCert(pubkey=XdrCurve25519Public(key=self._public.key),
                        expiration=expiration,
                        sig=self.config.NODE_SEED.sign(h))

    def get_auth_cert(self) -> AuthCert:
        if self._cert.expiration < int(self._now()) + \
                CERT_EXPIRATION_SECONDS // 2:
            self._cert = self._make_cert()
        return self._cert

    def verify_remote_cert(self, remote_node_raw: bytes,
                           cert: AuthCert) -> bool:
        if cert.expiration < int(self._now()):
            return False
        h = _cert_hash(self.network_id, cert.expiration,
                       bytes(cert.pubkey.key))
        return PubKeyUtils.verify_sig(remote_node_raw, bytes(cert.sig), h)

    # ---------------------------------------------------------------- keys --
    def _shared_key(self, remote_public: bytes, role: PeerRole) -> bytes:
        k = self._shared_cache.get((remote_public, role))
        if k is None:
            k = self._secret.ecdh(
                Curve25519Public(remote_public),
                local_first=(role == PeerRole.WE_CALLED_REMOTE))
            self._shared_cache[(remote_public, role)] = k
        return k

    def get_sending_mac_key(self, remote_public: bytes, local_nonce: bytes,
                            remote_nonce: bytes, role: PeerRole) -> bytes:
        if role == PeerRole.WE_CALLED_REMOTE:
            buf = b"\x00" + local_nonce + remote_nonce   # K_AB, A=local
        else:
            buf = b"\x01" + local_nonce + remote_nonce   # K_BA, B=local
        return expand_session_key(self._shared_key(remote_public, role), buf)

    def get_receiving_mac_key(self, remote_public: bytes,
                              local_nonce: bytes, remote_nonce: bytes,
                              role: PeerRole) -> bytes:
        if role == PeerRole.WE_CALLED_REMOTE:
            buf = b"\x01" + remote_nonce + local_nonce   # K_BA, A=local
        else:
            buf = b"\x00" + remote_nonce + local_nonce   # K_AB, B=local
        return expand_session_key(self._shared_key(remote_public, role), buf)
