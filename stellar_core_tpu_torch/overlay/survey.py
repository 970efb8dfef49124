"""Network topology survey.

Reference: src/overlay/SurveyManager.{h,cpp} + SurveyMessageLimiter —
an authenticated, encrypted survey protocol relayed over the overlay:
the surveyor signs SURVEY_REQUEST messages naming a surveyed peer and an
ephemeral Curve25519 key; the surveyed node answers with its peer
statistics encrypted to that key; intermediate nodes relay both
directions. Results feed the `surveytopology`/`getsurveyresult` admin
commands and scripts/OverlaySurvey.py-style walkers.

Encryption: sealed-box construction from the primitives in crypto/
(ephemeral X25519 → HKDF stream key + HMAC tag; the reference uses
libsodium's crypto_box_seal — same shape, same key exchange).
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os
import struct
from typing import Dict, List, Optional

from ..crypto.curve25519 import Curve25519Public, Curve25519Secret
from ..crypto.keys import PubKeyUtils
from ..crypto.sha import hkdf_expand, hkdf_extract, sha256
from ..util.logging import get_logger
from ..xdr.overlay import (MessageType, PeerStats,
                           SignedSurveyRequestMessage,
                           SignedSurveyResponseMessage, StellarMessage,
                           SurveyMessageCommandType, SurveyRequestMessage,
                           SurveyResponseMessage, SurveyResponseBody,
                           TopologyResponseBody)
from ..xdr.types import Curve25519Public as XdrCurve25519Public
from ..xdr.types import EnvelopeType, PublicKey

log = get_logger("Overlay")


# ------------------------------------------------------------- sealed box --

def _stream(key: bytes, n: int) -> bytes:
    out = b""
    counter = 0
    while len(out) < n:
        out += hashlib.sha256(key + struct.pack(">Q", counter)).digest()
        counter += 1
    return out[:n]


def seal(recipient_pub: bytes, plaintext: bytes) -> bytes:
    eph = Curve25519Secret.random()
    shared = eph.ecdh(Curve25519Public(recipient_pub), local_first=True)
    key = hkdf_expand(shared, b"survey-seal", 64)
    ct = bytes(a ^ b for a, b in zip(plaintext,
                                     _stream(key[:32], len(plaintext))))
    tag = _hmac.new(key[32:], ct, hashlib.sha256).digest()
    return eph.derive_public().key + tag + ct


def unseal(secret: Curve25519Secret, sealed: bytes) -> Optional[bytes]:
    if len(sealed) < 64:
        return None
    eph_pub, tag, ct = sealed[:32], sealed[32:64], sealed[64:]
    # recipient computes the same shared secret with roles flipped
    shared = secret.ecdh(Curve25519Public(eph_pub), local_first=False)
    key = hkdf_expand(shared, b"survey-seal", 64)
    if not _hmac.compare_digest(
            _hmac.new(key[32:], ct, hashlib.sha256).digest(), tag):
        return None
    return bytes(a ^ b for a, b in zip(ct, _stream(key[:32], len(ct))))


def _request_sign_bytes(network_id: bytes,
                        req: SurveyRequestMessage) -> bytes:
    return sha256(network_id
                  + struct.pack(">i", EnvelopeType.ENVELOPE_TYPE_AUTH)
                  + b"survey-req" + req.to_bytes())


def _response_sign_bytes(network_id: bytes,
                         resp: SurveyResponseMessage) -> bytes:
    return sha256(network_id
                  + struct.pack(">i", EnvelopeType.ENVELOPE_TYPE_AUTH)
                  + b"survey-resp" + resp.to_bytes())


class SurveyManager:
    def __init__(self, app):
        self.app = app
        self._secret = Curve25519Secret.random()
        self.results: Dict[bytes, dict] = {}   # surveyed node -> topology
        self._relayed: set = set()

    # -------------------------------------------------------------- start --
    def survey_peer(self, surveyed_raw: bytes) -> None:
        """Send a signed request for one node's topology (reference:
        SurveyManager::addNodeToRunningSurveyBacklog + sendTopologyRequest)."""
        cfg = self.app.config
        req = SurveyRequestMessage(
            surveyorPeerID=PublicKey.ed25519(cfg.node_id()),
            surveyedPeerID=PublicKey.ed25519(surveyed_raw),
            ledgerNum=self.app.ledger_manager.get_last_closed_ledger_num(),
            encryptionKey=XdrCurve25519Public(
                key=self._secret.derive_public().key),
            commandType=SurveyMessageCommandType.SURVEY_TOPOLOGY)
        signed = SignedSurveyRequestMessage(
            requestSignature=cfg.NODE_SEED.sign(
                _request_sign_bytes(cfg.network_id(), req)),
            request=req)
        self.app.overlay_manager.broadcast_message(StellarMessage(
            MessageType.SURVEY_REQUEST, signed))

    # ------------------------------------------------------------- handling --
    def handle_request(self, peer, msg: StellarMessage) -> None:
        signed: SignedSurveyRequestMessage = msg.value
        req = signed.request
        network_id = self.app.config.network_id()
        if not PubKeyUtils.verify_sig(
                bytes(req.surveyorPeerID.value),
                bytes(signed.requestSignature),
                _request_sign_bytes(network_id, req)):
            return
        if bytes(req.surveyedPeerID.value) == self.app.config.node_id():
            self._respond(req)
        else:
            self._relay(msg)

    def _respond(self, req: SurveyRequestMessage) -> None:
        cfg = self.app.config
        body = SurveyResponseBody(
            SurveyMessageCommandType.SURVEY_TOPOLOGY,
            self._topology_body())
        sealed = seal(bytes(req.encryptionKey.key), body.to_bytes())
        resp = SurveyResponseMessage(
            surveyorPeerID=req.surveyorPeerID,
            surveyedPeerID=PublicKey.ed25519(cfg.node_id()),
            ledgerNum=req.ledgerNum,
            commandType=SurveyMessageCommandType.SURVEY_TOPOLOGY,
            encryptedBody=sealed)
        signed = SignedSurveyResponseMessage(
            responseSignature=cfg.NODE_SEED.sign(
                _response_sign_bytes(cfg.network_id(), resp)),
            response=resp)
        self.app.overlay_manager.broadcast_message(StellarMessage(
            MessageType.SURVEY_RESPONSE, signed))

    def _topology_body(self) -> TopologyResponseBody:
        om = self.app.overlay_manager
        from .peer_auth import PeerRole

        def stats(p) -> PeerStats:
            return PeerStats(
                id=PublicKey.ed25519(p.peer_id),
                versionStr=p.remote_version.encode()[:100],
                messagesRead=p.messages_read,
                messagesWritten=p.messages_written,
                bytesRead=p.bytes_read, bytesWritten=p.bytes_written,
                secondsConnected=0, uniqueFloodBytesRecv=0,
                duplicateFloodBytesRecv=0, uniqueFetchBytesRecv=0,
                duplicateFetchBytesRecv=0, uniqueFloodMessageRecv=0,
                duplicateFloodMessageRecv=0, uniqueFetchMessageRecv=0,
                duplicateFetchMessageRecv=0)

        inbound = [stats(p) for p in om.get_authenticated_peers()
                   if p.role == PeerRole.REMOTE_CALLED_US][:25]
        outbound = [stats(p) for p in om.get_authenticated_peers()
                    if p.role == PeerRole.WE_CALLED_REMOTE][:25]
        return TopologyResponseBody(
            inboundPeers=inbound, outboundPeers=outbound,
            totalInboundPeerCount=len(inbound),
            totalOutboundPeerCount=len(outbound))

    def handle_response(self, peer, msg: StellarMessage) -> None:
        signed: SignedSurveyResponseMessage = msg.value
        resp = signed.response
        network_id = self.app.config.network_id()
        if not PubKeyUtils.verify_sig(
                bytes(resp.surveyedPeerID.value),
                bytes(signed.responseSignature),
                _response_sign_bytes(network_id, resp)):
            return
        if bytes(resp.surveyorPeerID.value) == self.app.config.node_id():
            plain = unseal(self._secret, bytes(resp.encryptedBody))
            if plain is None:
                log.debug("survey response failed to unseal")
                return
            body = SurveyResponseBody.from_bytes(plain)
            self.results[bytes(resp.surveyedPeerID.value)] = \
                _topology_json(body.value)
        else:
            self._relay(msg)

    def _relay(self, msg: StellarMessage) -> None:
        h = sha256(msg.to_bytes())
        if h in self._relayed:
            return
        self._relayed.add(h)
        self.app.overlay_manager.broadcast_message(msg)

    def results_json(self) -> dict:
        from ..crypto.strkey import StrKey
        # snapshot: HTTP threads read while the crank thread inserts
        return {StrKey.encode_ed25519_public(k): v
                for k, v in dict(self.results).items()}


def _topology_json(body: TopologyResponseBody) -> dict:
    from ..crypto.strkey import StrKey

    def fmt(peers):
        return [{"nodeId": StrKey.encode_ed25519_public(
                    bytes(p.id.value)),
                 "bytesRead": p.bytesRead,
                 "bytesWritten": p.bytesWritten,
                 "messagesRead": p.messagesRead,
                 "messagesWritten": p.messagesWritten} for p in peers]

    return {
        "inboundPeers": fmt(body.inboundPeers),
        "outboundPeers": fmt(body.outboundPeers),
        "totalInbound": body.totalInboundPeerCount,
        "totalOutbound": body.totalOutboundPeerCount,
    }
