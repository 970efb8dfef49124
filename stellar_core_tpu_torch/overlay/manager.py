"""Overlay manager: peer lifecycle + message routing + flooding.

Reference: src/overlay/OverlayManagerImpl.{h,cpp} (broadcastMessage
:1105, tick :613) and the Peer.cpp dispatch :519-585 for the
application-level message types, which land here via
`Peer.recv_message` → `handle_message`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..crypto.sha import sha256
from ..herder.pending_envelopes import RecvState
from ..util import chaos, tracing
from ..util.logging import get_logger
from ..xdr.overlay import (DontHave, MessageType, PeerAddress,
                           StellarMessage)
from ..xdr.scp import SCPQuorumSet
from . import wire
from .floodgate import Floodgate
from .item_fetcher import ItemFetcher
from .peer import Peer, PeerState
from .peer_auth import PeerAuth, PeerRole
from .tx_advert import (MAX_TX_DEMAND_VECTOR, TxAdvertQueue,
                        TxDemandsManager)

log = get_logger("Overlay")


# ratio keys the per-node reports derive from their own counts: a
# cross-node merge must SKIP these (summing ratios is meaningless) and
# re-derive them over the merged totals in finalize_flood_evidence —
# register any new derived key here and it is excluded automatically
DERIVED_EVIDENCE_KEYS = frozenset(
    {"single_flight_efficiency", "hit_ratio"})


def merge_flood_evidence(into: dict, add: dict) -> None:
    """Sum numeric leaves of one node's flood-evidence dict (the
    `demand_report`/`encode_report`/`flood_kind_report` shapes) into a
    cross-node total — nested dicts recursed, bools and
    `DERIVED_EVIDENCE_KEYS` excluded. Shared by bench's in-process
    `_flood_report` and the cluster harness's over-HTTP `flood_report`
    so the two artifact families can't drift."""
    for k, v in (add or {}).items():
        if k in DERIVED_EVIDENCE_KEYS:
            continue
        if isinstance(v, dict):
            merge_flood_evidence(into.setdefault(k, {}), v)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            into[k] = into.get(k, 0) + v


def finalize_flood_evidence(demand: dict, encode: dict) -> None:
    """Derive the `DERIVED_EVIDENCE_KEYS` ratios over MERGED totals."""
    d_total = demand.get("sent", 0) + demand.get("suppressed", 0)
    demand["single_flight_efficiency"] = round(
        demand.get("suppressed", 0) / d_total, 4) if d_total else 0.0
    e_total = encode.get("cache_hit", 0) + encode.get("cache_miss", 0)
    encode["hit_ratio"] = round(
        encode.get("cache_hit", 0) / e_total, 4) if e_total else 0.0


def _forge_bad_sig_frames(frame, burst: int, network_id: bytes) -> list:
    """Byzantine flood material: `burst` structurally-valid
    TransactionEnvelopes cloned from a real one with the seqNum bumped —
    each gets a fresh contents hash, so the cloned signature no longer
    verifies. Exactly what a flooder aiming at batch admission would
    send: every frame parses, every signature costs a verify, none can
    ever apply."""
    from ..tx.frame import make_frame
    from ..xdr.transaction import TransactionEnvelope
    from ..xdr.types import EnvelopeType
    env = frame.envelope
    if env.disc != EnvelopeType.ENVELOPE_TYPE_TX:
        return []
    raw = env.to_bytes()
    out = []
    for k in range(burst):
        twin = TransactionEnvelope.from_bytes(raw)
        twin.value.tx.seqNum += k + 1
        out.append(make_frame(twin, network_id))
    return out


class OverlayManager:
    def __init__(self, app):
        self.app = app
        self.peer_auth = PeerAuth(app.config,
                                  lambda: app.clock.system_now())
        self.floodgate = Floodgate()
        self.tx_set_fetcher = ItemFetcher(self, MessageType.GET_TX_SET)
        self.qset_fetcher = ItemFetcher(self, MessageType.GET_SCP_QUORUMSET)
        self._pending: List[Peer] = []
        self._authenticated: List[Peer] = []
        self._advert_queues: Dict[int, TxAdvertQueue] = {}
        # single-flight outstanding-demand table: each tx
        # hash is demanded from exactly ONE peer at a time; later
        # advertisers become retry backups (reference: TxDemandsManager)
        self.demands = TxDemandsManager(self.MAX_DEMAND_ATTEMPTS)
        self._tcp_peers: List[Peer] = []
        self._door = None
        self._shutting_down = False
        # batched flood admission: TRANSACTION bodies received
        # in one crank buffer here and drain as ONE prevalidated batch
        # through herder.recv_transactions on the next crank's posted
        # actions (only when the coalescing verify service is installed)
        self._tx_recv_buffer: List[object] = []
        self._tx_drain_posted = False
        # drop-reason tallies (reference: Peer::DropReason buckets) —
        # reasons are free text; the tally keys on the stable prefix
        # before any ':' detail so "send error: [Errno 32]…" buckets
        # as one reason, mirrored into overlay.peer.drop.* counters
        self.drop_reasons: Dict[str, int] = {}
        self._dns_cache: Dict[str, object] = {}
        # serialize-once encode-cache evidence + pull-mode demand
        # accounting: all on the metrics route + Prometheus
        metrics = getattr(app, "metrics", None)
        if metrics is not None:
            # (hit, miss) pair threaded through overlay/wire.py —
            # one broadcast to N peers must show exactly one miss
            self.encode_counters = (
                metrics.new_counter("overlay.encode.cache_hit"),
                metrics.new_counter("overlay.encode.cache_miss"))
            self._demand_meters = {
                k: metrics.new_meter(f"overlay.demand.{k}")
                for k in ("sent", "fulfilled", "timeout", "retry",
                          "suppressed")}
            # flood dedup verdicts split by kind: which traffic class
            # the duplicate_ratio is made of (SCP push gossip vs tx
            # pull bodies) — the attribution ROADMAP item 3 needs
            self._flood_kind_counters = {
                (kind, dup): metrics.new_counter(
                    "overlay.flood.%s.%s" %
                    ("duplicate" if dup else "unique", kind))
                for kind in ("scp", "tx") for dup in (False, True)}
            # per-class outbound load-shed:
            # one aggregate triple shared by every peer's FlowControl,
            # indexed by drop-priority class (scp, tx, gossip)
            from .flow_control import CLASS_NAMES
            self.flow_drop_counters = tuple(
                metrics.new_counter(f"overlay.flow.drop.{cls}")
                for cls in CLASS_NAMES)
            # SCP pushes suppressed because the link's floodgate digest
            # says the peer already signaled the envelope — the counter
            # that proves the dups/envelope floor is being attacked
            self._digest_suppressed = metrics.new_meter(
                "overlay.flood.digest.suppressed")
        else:
            self.encode_counters = None
            self._demand_meters = None
            self._flood_kind_counters = None
            self.flow_drop_counters = None
            self._digest_suppressed = None
        from .survey import SurveyManager
        self.survey_manager = SurveyManager(app)
        from .peer_manager import BanManager, PeerManager
        self.peer_manager = PeerManager(app)
        self.ban_manager = BanManager(app)
        self._tick_timer = None
        self._tick_rng = None    # lazy: seeded from config.jitter_seed()
        self._advert_timer = None
        self._advert_timer_armed = False
        self._demand_timer = None
        self._demand_timer_armed = False
        self._last_advert_flush = float("-inf")
        self._wire_herder()

    # -------------------------------------------------------------- wiring --
    def _wire_herder(self) -> None:
        herder = self.app.herder
        herder.broadcast_cb = self._broadcast_scp_envelope
        herder.ledger_closed_cb = self.ledger_closed
        herder.tx_advert_cb = self.advert_transaction
        herder.out_of_sync_cb = self._request_scp_state_from_peers
        herder.pending_envelopes.request_txset = self.tx_set_fetcher.fetch
        herder.pending_envelopes.request_qset = self.qset_fetcher.fetch

    def _request_scp_state(self, peer: Peer) -> None:
        """reference: HerderImpl::getMoreSCPState."""
        peer.send_message(StellarMessage(
            MessageType.GET_SCP_STATE, max(0, self._lcl_seq() - 1)))

    def _request_scp_state_from_peers(self) -> None:
        """Out-of-sync recovery: ask every peer for fresh SCP state."""
        # copy: a failed send can drop the peer mid-iteration
        for peer in list(self._authenticated):
            self._request_scp_state(peer)

    def _broadcast_scp_envelope(self, envelope) -> None:
        self.broadcast_message(
            StellarMessage(MessageType.SCP_MESSAGE, envelope))

    # --------------------------------------------------------------- peers --
    def add_pending_peer(self, peer: Peer) -> None:
        if len(self._pending) >= self.app.config.MAX_PENDING_CONNECTIONS:
            peer.drop("too many pending connections")
            return
        self._pending.append(peer)

    def peer_authenticated(self, peer: Peer) -> None:
        from .peer_auth import PeerRole
        cfg = self.app.config
        if peer in self._pending:
            self._pending.remove(peer)
        if chaos.ENABLED:
            # link-fault seam at admission: a reconnect
            # attempted while a `partition`/`flap` window is open on
            # this edge is refused right here — the redial loop keeps
            # knocking and succeeds only once the window heals
            link = chaos.point("overlay.link", None,
                               now=self.app.clock.now(),
                               **peer._chaos_ctx())
            if link is chaos.DROP:
                peer.drop("link down: chaos partition/flap")
                return
        if self.ban_manager.is_banned(peer.peer_id):
            peer.drop("banned")
            return
        # one authenticated connection per node id
        for other in self._authenticated:
            if other.peer_id == peer.peer_id:
                peer.drop("duplicate connection")
                return
        if peer.role == PeerRole.REMOTE_CALLED_US:
            # inbound cap (reference: MAX_ADDITIONAL_PEER_CONNECTIONS —
            # inbound slots on top of the outbound target)
            inbound = sum(1 for p in self._authenticated
                          if p.role == PeerRole.REMOTE_CALLED_US)
            if inbound >= cfg.max_inbound_peer_connections():
                peer.drop("too many inbound connections")
                return
            if cfg.PREFERRED_PEERS_ONLY and \
                    not self._is_preferred(peer):
                # reference: PREFERRED_PEERS_ONLY rejects everyone else
                peer.drop("not a preferred peer")
                return
        self._authenticated.append(peer)
        self._advert_queues[id(peer)] = TxAdvertQueue(self.app.config)
        log.debug("peer authenticated: %r", peer)
        self.tx_set_fetcher.peer_connected()
        self.qset_fetcher.peer_connected()
        # pull the peer's SCP state so consensus started before this
        # connection still reaches us (reference: Peer handshake →
        # sendGetScpState)
        self._request_scp_state(peer)

    # successful resolutions are cached this long; failures are NOT
    # cached at all — a transient resolver error or a DNS record change
    # must not permanently block a preferred peer until restart
    DNS_CACHE_TTL_SECONDS = 300.0

    def _resolve_host(self, host: str):
        """TTL-cached DNS resolution: a hit costs a dict lookup, an
        expired/missing entry re-resolves, and failures are never
        remembered (the next connection attempt retries)."""
        import time as _time
        now = _time.monotonic()
        hit = self._dns_cache.get(host)
        if hit is not None and now < hit[1]:
            return hit[0]
        if host == "localhost":
            ip = "127.0.0.1"
        else:
            try:
                import socket
                ip = socket.gethostbyname(host)
            except OSError:
                self._dns_cache.pop(host, None)
                return None
        self._dns_cache[host] = (ip, now + self.DNS_CACHE_TTL_SECONDS)
        return ip

    def _is_preferred(self, peer: Peer) -> bool:
        """Match a peer against PREFERRED_PEERS host:port entries (best
        effort: the listening port comes from HELLO; the host from the
        socket when there is one)."""
        port = getattr(peer, "remote_listening_port", 0)
        ip = None
        sock = getattr(peer, "sock", None)
        if sock is not None:
            try:
                ip = sock.getpeername()[0]
            except OSError:
                pass
        for entry in self.app.config.PREFERRED_PEERS:
            host, _, p = entry.rpartition(":")
            if not p.isdigit() or int(p) != port:
                continue
            if ip is None or host == ip:
                return True
            # PREFERRED_PEERS may name a DNS host (cached resolution)
            if self._resolve_host(host) == ip:
                return True
        return False

    def record_drop_reason(self, reason: str) -> None:
        key = (reason or "unknown").split(":", 1)[0].strip() or "unknown"
        self.drop_reasons[key] = self.drop_reasons.get(key, 0) + 1
        slug = "-".join("".join(
            c if c.isalnum() else " " for c in key.lower()).split())
        self.app.metrics.new_counter(
            f"overlay.peer.drop.{slug or 'unknown'}").inc()

    def peer_dropped(self, peer: Peer) -> None:
        if peer in self._pending:
            self._pending.remove(peer)
        if peer in self._authenticated:
            self._authenticated.remove(peer)
        self._advert_queues.pop(id(peer), None)
        self.floodgate.forget_peer(peer)
        self.tx_set_fetcher.peer_dropped(peer)
        self.qset_fetcher.peer_dropped(peer)

    def get_authenticated_peers(self) -> List[Peer]:
        return list(self._authenticated)

    def peers_json(self) -> dict:
        def fmt(peers):
            from ..crypto.strkey import StrKey
            return [{
                "id": StrKey.encode_ed25519_public(p.peer_id),
                "ver": p.remote_version,
                "olver": p.remote_overlay_version,
                # per-peer traffic counters (reference: the per-peer
                # metrics PeerSurvey reports — message/byte read+write)
                "messages_received": p.messages_read,
                "messages_sent": p.messages_written,
                "bytes_received": p.bytes_read,
                "bytes_sent": p.bytes_written,
                "bad_sig_drops": p.bad_sig_drops,
                # flood frames shed at admission by the adaptive
                # controller's surge gate (ops/controller.py)
                "shed_drops": p.shed_drops,
                # redundant flood deliveries this peer sent us — the
                # per-link share of the mesh's duplicate traffic
                "duplicates": p.duplicate_messages,
                # single-flight demand accounting per link
                "demand": {"sent": p.demand_sent,
                           "fulfilled": p.demand_fulfilled,
                           "timeout": p.demand_timeout,
                           "retry": p.demand_retry},
                # per-link outbound backpressure: queue
                # depth vs its byte budget, high-water mark, per-class
                # shed counts — the evidence a slow link is bounded
                "flow": p.flow.flow_stats(),
            } for p in peers if p.peer_id is not None]
        inbound = [p for p in self._authenticated
                   if p.role == PeerRole.REMOTE_CALLED_US]
        outbound = [p for p in self._authenticated
                    if p.role == PeerRole.WE_CALLED_REMOTE]
        out = {"inbound": fmt(inbound), "outbound": fmt(outbound),
               "drop_reasons": dict(self.drop_reasons)}
        prop = getattr(self.app, "propagation", None)
        if prop is not None:
            # aggregate flood-redundancy snapshot beside the per-peer
            # rows (ROADMAP item 3's flood-duplicate counter surface),
            # extended with the wire-path evidence: demand
            # single-flight totals, encode-cache efficiency, and the
            # SCP-vs-tx split of the dedup verdicts
            flood = prop.report()
            flood["demand"] = self.demand_report()
            flood["encode"] = self.encode_report()
            flood["by_kind"] = self.flood_kind_report()
            out["flood"] = flood
        return out

    def demand_report(self) -> dict:
        """Aggregate single-flight demand snapshot (peers route /
        bench + cluster flood sections): `outstanding` is the live
        table size; `suppressed` counts demands single-flight avoided
        (each one used to be a guaranteed duplicate body);
        `single_flight_efficiency` = share of advertised fetches the
        table collapsed into an already-in-flight demand."""
        if self._demand_meters is None:
            return {}
        counts = {k: m.count for k, m in self._demand_meters.items()}
        counts["outstanding"] = len(self.demands)
        total = counts["sent"] + counts["suppressed"]
        counts["single_flight_efficiency"] = round(
            counts["suppressed"] / total, 4) if total else 0.0
        return counts

    def encode_report(self) -> dict:
        """Serialize-once cache snapshot: hits are encodings the wire
        path did NOT perform (hash/HMAC/frame/flow-control consumers
        of an already-cached body)."""
        if self.encode_counters is None:
            return {}
        hit, miss = self.encode_counters
        total = hit.count + miss.count
        return {"cache_hit": hit.count, "cache_miss": miss.count,
                "hit_ratio": round(hit.count / total, 4)
                if total else 0.0}

    def flood_kind_report(self) -> dict:
        """unique/duplicate dedup verdicts split by traffic class."""
        if self._flood_kind_counters is None:
            return {}
        return {kind: {
            "unique": self._flood_kind_counters[(kind, False)].count,
            "duplicates": self._flood_kind_counters[(kind, True)].count,
        } for kind in ("scp", "tx")}

    def reset_peer_counters(self) -> None:
        """`clearmetrics` hook: per-peer message/byte/duplicate
        counters back to zero on every authenticated peer."""
        for p in self._authenticated:
            p.reset_traffic_counters()

    # ------------------------------------------------------- tcp transport --
    def start(self) -> None:
        """Open the listener + dial configured peers (reference:
        OverlayManagerImpl::start); no-op for RUN_STANDALONE."""
        cfg = self.app.config
        if not cfg.mode_auto_starts_overlay():
            return
        from .tcp_peer import PeerDoor, connect_to
        self._door = PeerDoor(self, cfg.PEER_PORT)
        self.app.clock.add_io_poller(self._poll_tcp)
        from .peer_manager import PeerType
        for addr in cfg.KNOWN_PEERS + cfg.PREFERRED_PEERS:
            host, _, port = addr.partition(":")
            self.peer_manager.ensure_exists(
                host, int(port or 11625),
                PeerType.PREFERRED if addr in cfg.PREFERRED_PEERS
                else PeerType.OUTBOUND)
            connect_to(self, host, int(port or 11625))
        self.tick()

    def register_tcp_peer(self, peer) -> None:
        self._tcp_peers.append(peer)

    def _poll_tcp(self) -> int:
        n = self._door.poll() if self._door is not None else 0
        for peer in list(self._tcp_peers):
            n += peer.poll()
            if peer.state == PeerState.CLOSING:
                self._tcp_peers.remove(peer)
        return n

    def _arm_advert_timer(self) -> None:
        """One-shot advert-batch drain, armed only while a batch is
        pending (reference: pull-mode flood cadence — adverts leave on a
        short timer, not one message per transaction). One-shot so an
        idle overlay leaves no timer on the clock: virtual-time tests
        step timer-to-timer and must not land on empty flood ticks."""
        if self._advert_timer_armed or self._shutting_down:
            return
        from ..util.timer import VirtualTimer
        if self._advert_timer is None:
            self._advert_timer = VirtualTimer(self.app.clock)
        self._advert_timer_armed = True
        self._advert_timer.expires_from_now(
            self.app.config.FLOOD_ADVERT_PERIOD_MS / 1000.0)
        self._advert_timer.async_wait(self._advert_timer_fired)

    def _advert_timer_fired(self) -> None:
        self._advert_timer_armed = False
        if self._shutting_down:
            return
        self.flush_adverts()

    MAX_DEMAND_ATTEMPTS = 3

    def _arm_demand_timer(self) -> None:
        """One-shot retry sweep for unanswered FLOOD_DEMANDs (reference:
        TxDemandsManager — a peer that never answers must not strand the
        transaction; re-demand from someone else)."""
        if self._demand_timer_armed or self._shutting_down:
            return
        from ..util.timer import VirtualTimer
        if self._demand_timer is None:
            self._demand_timer = VirtualTimer(self.app.clock)
        self._demand_timer_armed = True
        self._demand_timer.expires_from_now(
            self.app.config.FLOOD_DEMAND_PERIOD_MS / 1000.0)
        self._demand_timer.async_wait(self._demand_timer_fired)

    def _demand_timer_fired(self) -> None:
        self._demand_timer_armed = False
        if self._shutting_down:
            return
        now = self.app.clock.now()
        period = self.app.config.FLOOD_DEMAND_PERIOD_MS / 1000.0
        backoff = self.app.config.FLOOD_DEMAND_BACKOFF_DELAY_MS / 1000.0
        herder = self.app.herder
        peers_by_key = {id(p): p for p in self._authenticated}
        retries, timeouts = self.demands.sweep(
            now, period, backoff, peers_by_key,
            list(self._authenticated),
            is_known=lambda h: herder.tx_queue.get_tx(h) is not None)
        # charge each expiry to the peer that sat on the demand
        for pid in timeouts:
            p = peers_by_key.get(pid)
            if p is not None:
                p.demand_timeout += 1
        if timeouts and self._demand_meters is not None:
            self._demand_meters["timeout"].mark(len(timeouts))
        for target, hashes in retries.values():
            target.demand_retry += len(hashes)
            if self._demand_meters is not None:
                self._demand_meters["retry"].mark(len(hashes))
            self._send_demand(target, hashes, retry=True)
        if len(self.demands):
            self._arm_demand_timer()

    def shutdown(self) -> None:
        self._shutting_down = True
        self._tx_recv_buffer = []
        if self._tick_timer is not None:
            self._tick_timer.cancel()
            self._tick_timer = None
        if self._advert_timer is not None:
            self._advert_timer.cancel()
            self._advert_timer = None
        if self._demand_timer is not None:
            self._demand_timer.cancel()
            self._demand_timer = None
        for p in list(self._authenticated) + list(self._pending):
            p.drop("shutdown")
        if self._door is not None:
            self._door.close()
            self.app.clock.remove_io_poller(self._poll_tcp)
            self._door = None

    # ------------------------------------------------------------ flooding --
    def _lcl_seq(self) -> int:
        return self.app.ledger_manager.get_last_closed_ledger_num()

    def broadcast_message(self, msg: StellarMessage,
                          msg_hash: Optional[bytes] = None) -> int:
        # serialize-once: the flood hash is computed from the body
        # bytes cached on the message (encoded here if this node
        # authored it, seeded from the wire slice if it is relaying),
        # and every peer's frame below splices around that same body
        h = msg_hash if msg_hash is not None \
            else wire.flood_hash(msg, self.encode_counters)
        sent = self.floodgate.broadcast(msg, self._authenticated,
                                        self._lcl_seq(), msg_hash=h)
        if msg.disc == MessageType.SCP_MESSAGE and \
                self._digest_suppressed is not None:
            # per-link digest evidence: every authenticated
            # peer the floodgate skipped is one push-gossip duplicate
            # that did NOT go out — the counter duplicate_ratio
            # improvements are judged against
            eligible = sum(1 for p in self._authenticated
                           if p.is_authenticated())
            if eligible > sent:
                self._digest_suppressed.mark(eligible - sent)
        if sent and msg.disc in (MessageType.SCP_MESSAGE,
                                 MessageType.TRANSACTION):
            # hash-keyed propagation stamp (overlay/propagation.py):
            # the send side of the mesh observatory's flood hops.
            # Flooded consensus/tx traffic only — survey relays also
            # broadcast, but have no recv-side stamp and would pollute
            # the flood analytics with send-only entries
            prop = getattr(self.app, "propagation", None)
            if prop is not None:
                prop.on_send(h, sent)
            if tracing.ENABLED:
                rec = self.app.flight_recorder
                if rec.active:
                    rec.instant("flood.send", {
                        "hash": h.hex()[:16], "type": msg.disc.name,
                        "n": sent})
        return sent

    # ------------------------------------------------------------ dispatch --
    def handle_message(self, peer: Peer, msg: StellarMessage) -> None:
        t = msg.disc
        handler = {
            MessageType.GET_TX_SET: self._on_get_tx_set,
            MessageType.TX_SET: self._on_tx_set,
            MessageType.GENERALIZED_TX_SET: self._on_tx_set,
            MessageType.GET_SCP_QUORUMSET: self._on_get_qset,
            MessageType.SCP_QUORUMSET: self._on_qset,
            MessageType.SCP_MESSAGE: self._on_scp_message,
            MessageType.GET_SCP_STATE: self._on_get_scp_state,
            MessageType.TRANSACTION: self._on_transaction,
            MessageType.DONT_HAVE: self._on_dont_have,
            MessageType.FLOOD_ADVERT: self._on_flood_advert,
            MessageType.FLOOD_DEMAND: self._on_flood_demand,
            MessageType.GET_PEERS: self._on_get_peers,
            MessageType.PEERS: self._on_peers,
            MessageType.SURVEY_REQUEST:
                lambda p, m: self.survey_manager.handle_request(p, m),
            MessageType.SURVEY_RESPONSE:
                lambda p, m: self.survey_manager.handle_response(p, m),
        }.get(t)
        if handler is None:
            log.debug("unhandled message type %s from %r", t, peer)
            return
        handler(peer, msg)

    # ------------------------------------------------------- fetch serving --
    def _on_get_tx_set(self, peer, msg) -> None:
        h = bytes(msg.value)
        tx_set = self.app.herder.pending_envelopes.get_tx_set(h)
        if tx_set is None:
            peer.send_message(StellarMessage(
                MessageType.DONT_HAVE,
                DontHave(type=MessageType.TX_SET, reqHash=h)))
            return
        xdr_set = tx_set.to_xdr()
        if tx_set.is_generalized:
            peer.send_message(StellarMessage(
                MessageType.GENERALIZED_TX_SET, xdr_set))
        else:
            peer.send_message(StellarMessage(MessageType.TX_SET, xdr_set))

    def _on_tx_set(self, peer, msg) -> None:
        from ..herder.tx_set import TxSetFrame
        frame = TxSetFrame(msg.value, self.app.config.network_id())
        h = frame.get_contents_hash()
        self.tx_set_fetcher.recv(h)
        self.app.herder.recv_tx_set(h, frame)

    def _on_get_qset(self, peer, msg) -> None:
        h = bytes(msg.value)
        qset = self.app.herder.pending_envelopes.get_qset(h)
        if qset is None:
            peer.send_message(StellarMessage(
                MessageType.DONT_HAVE,
                DontHave(type=MessageType.SCP_QUORUMSET, reqHash=h)))
            return
        peer.send_message(StellarMessage(MessageType.SCP_QUORUMSET, qset))

    def _on_qset(self, peer, msg) -> None:
        qset = msg.value
        h = sha256(qset.to_bytes())
        self.qset_fetcher.recv(h)
        self.app.herder.recv_scp_quorum_set(h, qset)

    def _on_dont_have(self, peer, msg) -> None:
        dh = msg.value
        if dh.type == MessageType.TX_SET:
            self.tx_set_fetcher.dont_have(bytes(dh.reqHash), peer)
        elif dh.type == MessageType.SCP_QUORUMSET:
            self.qset_fetcher.dont_have(bytes(dh.reqHash), peer)

    # ----------------------------------------------------------- consensus --
    def _on_scp_message(self, peer, msg) -> None:
        envelope = msg.value
        # cache seeded from the wire slice on recv: hashing a relayed
        # message re-encodes nothing
        h = wire.flood_hash(msg, self.encode_counters)
        new = self.floodgate.add_record(msg, peer, self._lcl_seq(),
                                        msg_hash=h)
        # propagation stamp + duplicate accounting: the floodgate's
        # dedup record is the authority on whether this delivery was
        # redundant; the duplicate is charged to the delivering peer
        prop = getattr(self.app, "propagation", None)
        if prop is not None:
            prop.on_recv(h, duplicate=not new)
        if not new:
            peer.duplicate_messages += 1
        if self._flood_kind_counters is not None:
            self._flood_kind_counters[("scp", not new)].inc()
        if tracing.ENABLED:
            rec = self.app.flight_recorder
            if rec.active:
                rec.instant("flood.recv", {
                    "hash": h.hex()[:16], "type": "SCP_MESSAGE",
                    "from": peer.peer_id.hex()[:8]
                    if peer.peer_id else "?", "dup": not new})
        if new:
            status = self.app.herder.recv_scp_envelope(envelope)
            # relay gate: only envelopes that can still
            # advance consensus somewhere — slot at or above our LCL —
            # are re-flooded. The LCL slot itself must keep relaying
            # (followers one slot behind externalize off our quorum's
            # EXTERNALIZE statements), but strictly-older envelopes
            # inside the remember window are INGESTED (quorum
            # tracking, catchup) without re-flooding: the boot/churn
            # GET_SCP_STATE echoes measured as the largest SCP
            # duplicate source in the cluster harness (a restarted
            # node re-flooded every remembered slot's statements to
            # neighbors that externalized them long ago). A peer that
            # needs history asks for it (GET_SCP_STATE), it does not
            # need us to gossip the past.
            if status != RecvState.ENVELOPE_STATUS_DISCARDED and \
                    envelope.statement.slotIndex >= self._lcl_seq():
                self.broadcast_message(msg, msg_hash=h)

    def _on_get_scp_state(self, peer, msg) -> None:
        """Send our latest SCP state for (and above) the requested seq
        (reference: Peer::recvGetSCPState → Herder::sendSCPStateToPeer)."""
        herder = self.app.herder
        if herder.scp is None:
            return
        from_seq = msg.value
        for slot_index in sorted(herder.scp.known_slots):
            if from_seq and slot_index < from_seq:
                continue
            for env in herder.scp.get_current_state(slot_index):
                m = StellarMessage(MessageType.SCP_MESSAGE, env)
                # per-link SCP digest: the peer now holds
                # this envelope — a later flood broadcast must not
                # re-push it down this link. Catchup-served state was
                # a guaranteed source of push-gossip duplicates after
                # every partition heal / churn rejoin.
                self.floodgate.note_told(
                    wire.flood_hash(m, self.encode_counters), peer,
                    self._lcl_seq())
                peer.send_message(m)

    # -------------------------------------------------------- transactions --
    def _on_transaction(self, peer, msg) -> None:
        from ..tx.frame import make_frame
        from ..util import chaos
        frame = make_frame(msg.value, self.app.config.network_id())
        h = frame.full_hash()
        # retire the single-flight demand record; fulfillment credit
        # goes to the peer we actually demanded from (a body from
        # anyone else still satisfies the fetch, but is the kind of
        # unsolicited push the demand table exists to make rare)
        rec = self.demands.fulfilled(h)
        if rec is not None:
            if rec.peer_key == id(peer):
                peer.demand_fulfilled += 1
            if self._demand_meters is not None:
                self._demand_meters["fulfilled"].mark()
        # propagation stamp keyed by the tx contents hash (the same
        # key the tx e2e track uses): a body this node already
        # received or admitted is a redundant delivery, charged to the
        # peer that sent it
        prop = getattr(self.app, "propagation", None)
        dup = False
        if prop is not None:
            dup = prop.on_recv(h)
            if dup:
                peer.duplicate_messages += 1
        if self._flood_kind_counters is not None:
            self._flood_kind_counters[("tx", dup)].inc()
        if tracing.ENABLED:
            rec = self.app.flight_recorder
            if rec.active:
                rec.instant("flood.recv", {
                    "hash": h.hex()[:16], "type": "TRANSACTION",
                    "from": peer.peer_id.hex()[:8]
                    if peer.peer_id else "?", "dup": dup})
        frames = [frame]
        if chaos.ENABLED:
            # Byzantine flood seam: a `bad_sig_flood` fault
            # here models the sending peer bursting well-formed
            # transactions with INVALID signatures alongside each real
            # body — aimed straight at the verify service's batch
            # admission. Forged from the real frame so everything is
            # structurally valid; attribution stays with the peer the
            # template came from (the flooder).
            cfg = self.app.config
            out = chaos.point(
                "overlay.transaction.recv", frame,
                node=cfg.node_id().hex() if cfg.NODE_SEED is not None
                else "",
                peer=peer.peer_id.hex() if peer.peer_id else "")
            if isinstance(out, chaos.BadSigBurst):
                frames += _forge_bad_sig_frames(
                    frame, out.burst, cfg.network_id())
        # surge shedding (ops/controller.py): drop decisions run HERE,
        # before the batched recv_transactions verify dispatch on
        # either path below — a shed frame costs this node zero device
        # time and zero try_add work. Shed frames are charged to the
        # per-peer `shed_drops` accounting (the `peers` route), not to
        # bad-sig accounting: nothing was verified, so nothing can be
        # called invalid. The roll covers everything the peer actually
        # sent — chaos-forged bad-sig bursts included.
        ctl = getattr(self.app, "controller", None)
        if ctl is not None and ctl.shed_flood > 0.0:
            kept = []
            for f in frames:
                if ctl.roll_flood_shed():
                    peer.shed_drops += 1
                else:
                    kept.append(f)
            frames = kept
            if not frames:
                return
        if self.app.herder.verify_service is None:
            # no batch accelerator: admit synchronously, as before —
            # but still through the bad_sig-reporting batched API, so
            # per-peer flooder accounting (and the drop threshold)
            # works on native-backend nodes too: the multi-process
            # cluster harness runs its chaos legs exactly there
            bad: List[bool] = []
            self.app.herder.recv_transactions(frames, bad_sig=bad)
            for is_bad in bad:
                if is_bad:
                    self.record_bad_sig(peer)
            return
        # coalescing path: buffer the crank's burst of received bodies
        # and admit them as ONE prevalidated batch on the next crank
        # (posted actions run before any further delivery), so a flood
        # burst pays one device dispatch instead of per-signature verify
        for f in frames:
            self._tx_recv_buffer.append((peer, f))
        if not self._tx_drain_posted:
            self._tx_drain_posted = True
            self.app.clock.post(self._drain_recv_transactions)

    def _drain_recv_transactions(self) -> None:
        self._tx_drain_posted = False
        buffered, self._tx_recv_buffer = self._tx_recv_buffer, []
        if not buffered or self._shutting_down:
            return
        from ..main.application import AppState
        if self.app.state == AppState.APP_STOPPING_STATE:
            return   # a crashed/buried node must not keep admitting
        # duplicate bodies (the same tx demanded from two peers before
        # either answered) collapse here; try_add would dedup anyway,
        # but the batch verify should not pay for them twice
        seen = set()
        batch = []
        for peer, f in buffered:
            h = f.full_hash()
            if h in seen:
                continue
            seen.add(h)
            batch.append((peer, f))
        bad_sig: List[bool] = []
        self.app.herder.recv_transactions([f for _, f in batch],
                                          bad_sig=bad_sig)
        # per-peer invalid-signature accounting:
        # the admission batch just told us exactly which envelopes
        # carried signatures that verified False — charge them to the
        # peer that delivered the body
        for (peer, _f), is_bad in zip(batch, bad_sig):
            if is_bad:
                self.record_bad_sig(peer)

    def record_bad_sig(self, peer: Peer, n: int = 1) -> None:
        """Count an invalid-signature transaction against `peer`; past
        PEER_BAD_SIG_DROP_THRESHOLD the peer takes the standard drop
        path (a flooder must not keep monopolizing verify batches).
        Surfaces as the per-peer `bad_sig_drops` field on the `peers`
        route and the aggregate `overlay.peer.drop.bad_sig` counter
        (metrics route + Prometheus)."""
        peer.bad_sig_drops += n
        self.app.metrics.new_counter("overlay.peer.drop.bad_sig").inc(n)
        thr = self.app.config.PEER_BAD_SIG_DROP_THRESHOLD
        if thr > 0 and peer.bad_sig_drops >= thr and \
                peer.state != PeerState.CLOSING:
            peer.drop("bad sig flood")

    def advert_transaction(self, tx_hash: bytes,
                           exclude: Optional[Peer] = None) -> None:
        """Queue the hash on every peer's advert batch (reference:
        TxAdvertQueue batches up to TX_ADVERT_VECTOR hashes per
        FLOOD_ADVERT; flushes ride the flood cadence, not one message
        per transaction). Cadence: a full batch sends at once; an idle
        overlay (no flush within the last period) flushes immediately so
        a lone transaction pays no timer latency; inside the cooldown a
        burst batches until the one-shot timer / ledger close fires."""
        # copy: a failed send can drop the peer mid-iteration
        for p in list(self._authenticated):
            if p is exclude:
                continue
            q = self._advert_queues.get(id(p))
            if q is None:
                continue
            full = q.queue_advert(tx_hash)
            if full is not None:
                p.send_message(full)
        now = self.app.clock.now()
        period = self.app.config.FLOOD_ADVERT_PERIOD_MS / 1000.0
        if now - self._last_advert_flush >= period:
            self.flush_adverts()
        else:
            self._arm_advert_timer()

    def flush_adverts(self) -> None:
        self._last_advert_flush = self.app.clock.now()
        # copy: a failed send can drop the peer mid-iteration
        for p in list(self._authenticated):
            q = self._advert_queues.get(id(p))
            if q is None:
                continue
            flushed = q.flush_advert()
            if flushed is not None:
                p.send_message(flushed)

    def _send_demand(self, peer, hashes: List[bytes],
                     retry: bool = False) -> None:
        """Send FLOOD_DEMANDs with per-peer + aggregate accounting and
        a hash-count trace instant (the demand leg of
        `trace_report.py --flood`'s single-flight efficiency view).
        Chunked to MAX_TX_DEMAND_VECTOR per message: the demands table
        has already stamped EVERY hash as in-flight from this peer, so
        an oversized batch (a retry sweep rotating a large backlog
        onto one survivor) must transmit them all — truncating here
        would leave the tail waiting out a full timeout for a demand
        that never went on the wire."""
        for i in range(0, len(hashes), MAX_TX_DEMAND_VECTOR):
            peer.send_message(TxAdvertQueue.make_demand(
                hashes[i:i + MAX_TX_DEMAND_VECTOR]))
        peer.demand_sent += len(hashes)
        if self._demand_meters is not None:
            self._demand_meters["sent"].mark(len(hashes))
        if tracing.ENABLED:
            rec = self.app.flight_recorder
            if rec.active:
                rec.instant("flood.demand", {
                    "n": len(hashes), "retry": retry,
                    "peer": peer.peer_id.hex()[:8]
                    if peer.peer_id else "?"})

    def _on_flood_advert(self, peer, msg) -> None:
        herder = self.app.herder

        def known(h: bytes) -> bool:
            return herder.tx_queue.get_tx(h) is not None or \
                herder.tx_queue.is_banned(h)

        q = self._advert_queues.get(id(peer))
        if q is None:
            return
        demand = q.recv_advert(msg.value.txHashes, known)
        if not demand:
            return
        # single-flight: only hashes with no demand already
        # in flight are demanded from this peer; for the rest the peer
        # is recorded as a retry backup — two peers advertising the
        # same hash used to mean two demands and a guaranteed
        # duplicate body
        now = self.app.clock.now()
        to_send = [h for h in demand
                   if self.demands.note_advert(h, id(peer), now)]
        suppressed = len(demand) - len(to_send)
        if suppressed and self._demand_meters is not None:
            self._demand_meters["suppressed"].mark(suppressed)
        if to_send:
            self._send_demand(peer, to_send)
        self._arm_demand_timer()

    def _on_flood_demand(self, peer, msg) -> None:
        herder = self.app.herder
        prop = getattr(self.app, "propagation", None)
        for h in msg.value.txHashes:
            h = bytes(h)
            tx = herder.tx_queue.get_tx(h)
            if tx is not None:
                # serialize-once: one TRANSACTION wrapper per frame,
                # stashed on it — every peer demanding this body (and
                # every flow-control sizing of it) hits the same
                # cached encoding instead of re-wrapping + re-encoding
                out = getattr(tx, "_flood_msg", None)
                if out is None:
                    out = StellarMessage(MessageType.TRANSACTION,
                                         tx.envelope)
                    tx._flood_msg = out
                peer.send_message(out)
                if prop is not None:
                    prop.on_send(h, 1)
                if tracing.ENABLED:
                    rec = self.app.flight_recorder
                    if rec.active:
                        rec.instant("flood.send", {
                            "hash": h.hex()[:16],
                            "type": "TRANSACTION", "n": 1})

    # ---------------------------------------------------------------- misc --
    def _on_get_peers(self, peer, msg) -> None:
        """Answer with known dialable peers (reference: recvGetPeers →
        sendPeers, up to 100)."""
        from ..xdr.overlay import IPAddrType, PeerAddress, _PeerAddressIp
        out = []
        for ip, port, failures, _t in self.peer_manager.known_peers():
            try:
                packed = bytes(int(x) for x in ip.split("."))
            except ValueError:
                continue
            if len(packed) != 4:
                continue
            out.append(PeerAddress(
                ip=_PeerAddressIp(IPAddrType.IPv4, packed),
                port=port, numFailures=failures))
            if len(out) >= 100:
                break
        peer.send_message(StellarMessage(MessageType.PEERS, out))

    def _on_peers(self, peer, msg) -> None:
        self.peer_manager.store_peer_list(list(msg.value))

    # ---------------------------------------------------------------- tick --
    def tick(self) -> None:
        """Connection maintenance (reference: OverlayManagerImpl::tick
        :613): top up outbound TCP connections toward the target."""
        cfg = self.app.config
        if cfg.RUN_STANDALONE or self._shutting_down:
            return
        if cfg.ARTIFICIALLY_SKIP_CONNECTION_ADJUSTMENT_FOR_TESTING:
            # reference: tests freeze the connection set mid-scenario
            return
        from .peer_auth import PeerRole
        outbound = [p for p in self._authenticated
                    if p.role == PeerRole.WE_CALLED_REMOTE]
        missing = cfg.TARGET_PEER_CONNECTIONS - len(outbound)
        if missing > 0:
            from .tcp_peer import connect_to
            if cfg.PREFERRED_PEERS_ONLY:
                # reference: PREFERRED_PEERS_ONLY — dial nobody else.
                # Dedup against live outbound by (host, port): distinct
                # hosts routinely share the standard port.
                have = set()
                for p in outbound:
                    sock = getattr(p, "sock", None)
                    ip = None
                    if sock is not None:
                        try:
                            ip = sock.getpeername()[0]
                        except OSError:
                            pass
                    have.add((ip, p.remote_listening_port))
                cands = []
                for entry in cfg.PREFERRED_PEERS:
                    host, _, p = entry.rpartition(":")
                    if not p.isdigit():
                        continue
                    resolved = self._resolve_host(host)
                    if (resolved, int(p)) not in have and \
                            (host, int(p)) not in have:
                        cands.append((host, int(p)))
                cands = cands[:missing]
            else:
                cands = self.peer_manager.candidates(missing)
            for ip, port in cands:
                if (ip == "localhost" or ip.startswith("127.")) and \
                        not cfg.ALLOW_LOCALHOST_FOR_TESTING:
                    # reference: localhost peers rejected outside tests
                    log.warning(
                        "skipping localhost peer %s:%d "
                        "(ALLOW_LOCALHOST_FOR_TESTING is off)", ip, port)
                    continue
                connect_to(self, ip, port)
        from ..util.timer import VirtualTimer
        self._tick_timer = VirtualTimer(self.app.clock)
        self._tick_timer.expires_from_now(self.tick_interval())
        self._tick_timer.async_wait(self.tick)

    def tick_interval(self) -> float:
        """Jitter-decorrelated dial-retry period: a fixed
        5.0 s re-arm made every node that lost a peer to the same
        partition/flap window redial in LOCKSTEP — a thundering herd
        against the healing listener. Per-node seeded jitter
        (config.jitter_seed(), the decorrelation discipline)
        spreads the retries over [3.75, 6.25) s while keeping each
        node's sequence reproducible."""
        if self._tick_rng is None:
            import random
            self._tick_rng = random.Random(
                self.app.config.jitter_seed() ^ 0x7E9C_11A3)
        return 5.0 * (0.75 + 0.5 * self._tick_rng.random())

    # ---------------------------------------------------------- ledger tick --
    def ledger_closed(self, ledger_seq: int) -> None:
        self.floodgate.clear_below(ledger_seq)
        self.flush_adverts()
