"""Peer database + ban list + automatic connection maintenance.

Reference: src/overlay/PeerManager.{h,cpp} (peers table with
nextattempt/numfailures/type and exponential backoff),
RandomPeerSource.{h,cpp} (candidate selection), BanManager.{h,cpp}
(node-id bans), and OverlayManagerImpl::tick (:613 — top up outbound
connections toward TARGET_PEER_CONNECTIONS).
"""

from __future__ import annotations

import random
from enum import IntEnum
from typing import List, Optional, Tuple

from ..util.logging import get_logger
from ..util.timer import VirtualTimer

log = get_logger("Overlay")


class PeerType(IntEnum):
    # reference: PeerManager.h PeerType
    INBOUND = 0
    OUTBOUND = 1
    PREFERRED = 2


# reference: PeerManager::backOff — exponential, capped
MAX_BACKOFF_SECONDS = 24 * 3600
BASE_BACKOFF_SECONDS = 30


class PeerManager:
    def __init__(self, app):
        self.app = app
        self._rng = random.Random(0xBEEF)

    # ------------------------------------------------------------ peer rows --
    def ensure_exists(self, ip: str, port: int,
                      peer_type: PeerType = PeerType.OUTBOUND) -> None:
        db = self.app.database
        row = db.query_one(
            "SELECT 1 FROM peers WHERE ip=? AND port=?", (ip, port))
        if row is None:
            db.execute(
                "INSERT INTO peers (ip, port, nextattempt, numfailures, "
                "type) VALUES (?,?,0,0,?)", (ip, port, int(peer_type)))

    def update_success(self, ip: str, port: int) -> None:
        self.app.database.execute(
            "UPDATE peers SET numfailures=0, nextattempt=0 "
            "WHERE ip=? AND port=?", (ip, port))

    def update_failure(self, ip: str, port: int) -> None:
        now = int(self.app.clock.system_now())
        row = self.app.database.query_one(
            "SELECT numfailures FROM peers WHERE ip=? AND port=?",
            (ip, port))
        failures = (row[0] if row else 0) + 1
        backoff = min(BASE_BACKOFF_SECONDS * (2 ** min(failures, 12)),
                      MAX_BACKOFF_SECONDS)
        # jittered like the reference's randomized backoff
        backoff = self._rng.randint(backoff // 2, backoff)
        self.app.database.execute(
            "UPDATE peers SET numfailures=?, nextattempt=? "
            "WHERE ip=? AND port=?", (failures, now + backoff, ip, port))

    def candidates(self, n: int) -> List[Tuple[str, int]]:
        """Random eligible peers to dial (reference: RandomPeerSource)."""
        now = int(self.app.clock.system_now())
        rows = self.app.database.query_all(
            "SELECT ip, port FROM peers WHERE nextattempt <= ? "
            "ORDER BY type DESC, numfailures ASC LIMIT ?", (now, 4 * n))
        rows = list(rows)
        self._rng.shuffle(rows)
        return [(ip, port) for ip, port in rows[:n]]

    def known_peers(self) -> List[Tuple[str, int, int, int]]:
        return list(self.app.database.query_all(
            "SELECT ip, port, numfailures, type FROM peers"))

    def store_peer_list(self, addresses) -> None:
        """PEERS message payload → db (reference: recvPeers)."""
        for addr in addresses:
            if addr.ip.disc == 0:  # IPv4
                ip = ".".join(str(b) for b in bytes(addr.ip.value))
                if 0 < addr.port < 65536:
                    self.ensure_exists(ip, addr.port)


class BanManager:
    """reference: BanManager.{h,cpp} — node-id ban table consulted at
    auth time and managed over the admin API."""

    def __init__(self, app):
        self.app = app

    def ban_node(self, node_id_raw: bytes) -> None:
        self.app.database.execute(
            "INSERT OR REPLACE INTO ban (nodeid) VALUES (?)",
            (node_id_raw,))

    def unban_node(self, node_id_raw: bytes) -> None:
        self.app.database.execute(
            "DELETE FROM ban WHERE nodeid=?", (node_id_raw,))

    def is_banned(self, node_id_raw: bytes) -> bool:
        return self.app.database.query_one(
            "SELECT 1 FROM ban WHERE nodeid=?", (node_id_raw,)) is not None

    def banned_nodes(self) -> List[bytes]:
        return [bytes(r[0]) for r in self.app.database.query_all(
            "SELECT nodeid FROM ban")]
