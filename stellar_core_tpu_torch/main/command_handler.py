"""Admin HTTP command handler.

Reference: src/main/CommandHandler.{h,cpp} — routes at :87-125. The
dispatch core (`handle`) is pure so tests exercise commands without
sockets; `run_http_server` wraps it in a stdlib ThreadingHTTPServer whose
handlers post work onto the main VirtualClock, preserving the reference's
single-main-thread discipline (docs/architecture.md:24-36).
"""

from __future__ import annotations

import base64
import binascii
import json
import threading
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..herder.tx_queue import AddResult
from ..util.logging import get_logger, set_log_level
from ..xdr.transaction import TransactionEnvelope

log = get_logger("default")


class CommandHandler:
    def __init__(self, app):
        self.app = app

    # ------------------------------------------------------------ dispatch --
    def handle(self, command: str, params: Optional[Dict[str, str]] = None,
               ) -> dict:
        params = params or {}
        routes = {
            "info": self._info,
            "metrics": self._metrics,
            "clearmetrics": self._clear_metrics,
            "tx": self._tx,
            "manualclose": self._manual_close,
            "upgrades": self._upgrades,
            "ll": self._log_level,
            "peers": self._peers,
            "quorum": self._quorum,
            "maintenance": self._maintenance,
            "setcursor": self._set_cursor,
            "getcursor": self._get_cursor,
            "dropcursor": self._drop_cursor,
            "self-check": self._self_check,
            "surveytopology": self._survey_topology,
            "getsurveyresult": self._get_survey_result,
            "ban": self._ban,
            "unban": self._unban,
            "bans": self._bans,
            "connect": self._connect,
            "droppeer": self._drop_peer,
            "scp": self._scp_info,
            "getledgerentry": self._get_ledger_entry,
            "generateload": self._generate_load,
            "perf": self._perf,
            "chaos": self._chaos,
            "backendstatus": self._backend_status,
            "starttrace": self._start_trace,
            "stoptrace": self._stop_trace,
            "dumptrace": self._dump_trace,
            # input recording (replay/): docs/REPLAY.md
            "recordstart": self._record_start,
            "recordstop": self._record_stop,
            "recorddump": self._record_dump,
            "clusterstatus": self._cluster_status,
            "timeseries": self._timeseries,
            "slo": self._slo,
            "controller": self._controller,
            # read-serving tier (query/): snapshot-consistent reads
            "account": self._account,
            "txstatus": self._tx_status,
            "snapshotinfo": self._snapshot_info,
        }
        fn = routes.get(command)
        if fn is None:
            return {"exception": f"unknown command: {command}"}
        rec = getattr(self.app, "input_recorder", None)
        if rec is not None and rec.active:
            # state-mutating admin commands are node inputs: recorded
            # on arrival (before execution, like a wire frame) so
            # replay re-drives them at the same instant. `tx` is
            # recorded as an INJECT inside _tx, bytes-exact.
            rec.record_admin(command, params)
        try:
            return fn(params)
        except Exception as e:  # surfaced as the reference does
            log.error("command %s failed: %s", command, e)
            return {"exception": str(e)}

    # -------------------------------------------------------------- routes --
    def _info(self, params) -> dict:
        return {"info": self.app.info()}

    def _sync_verify_cache_meters(self) -> None:
        """Drain the process-wide verify-cache hit/miss counters (only
        reachable via flush_verify_cache_counts before) into
        crypto.verify.cache.{hit,miss} meters, so they ride the metrics
        route and the Prometheus exposition like every other metric.
        The meters always exist (zero-valued) so scrapers see stable
        families."""
        from ..crypto.keys import flush_verify_cache_counts
        h, m = flush_verify_cache_counts()
        hit = self.app.metrics.meter("crypto", "verify", "cache", "hit")
        miss = self.app.metrics.meter("crypto", "verify", "cache", "miss")
        if h:
            hit.mark(h)
        if m:
            miss.mark(m)

    def _metrics(self, params) -> dict:
        # perf zones ride along so the per-phase closeLedger breakdown
        # (ledger.close.applyTx / .seal / .complete, …) is visible from
        # the same admin endpoint operators already scrape
        self._sync_verify_cache_meters()
        if params.get("format") == "prometheus":
            # text exposition for scrapers: the whole MetricsRegistry
            # plus the zone report as labeled gauge families
            from ..util.metrics import render_prometheus
            return {"_raw_body": render_prometheus(
                        self.app.metrics.to_json(),
                        self.app.perf.report()),
                    "_content_type":
                        "text/plain; version=0.0.4; charset=utf-8"}
        out = {"metrics": self.app.metrics.to_json(),
               "perf_zones": self.app.perf.report()}
        from ..util import chaos
        if chaos.ENABLED:
            # chaos.injected.* counters surface beside the metrics an
            # operator is already watching during an injection run
            out["chaos"] = chaos.status()
        return out

    def _clear_metrics(self, params) -> dict:
        self.app.metrics.clear()
        # the zone registry is the same operator surface: clearing one
        # and not the other left `perf` reporting stale zones forever
        self.app.perf.reset()
        # per-peer message/byte/duplicate counters and the hash-keyed
        # stamp dicts reset too, so bench legs sharing one process
        # measure each window from a clean slate (previously only
        # meters and perf zones reset — the peers route kept counting
        # across legs)
        overlay = getattr(self.app, "overlay_manager", None)
        if overlay is not None:
            overlay.reset_peer_counters()
        prop = getattr(self.app, "propagation", None)
        if prop is not None:
            prop.clear()
        self.app.herder.reset_observability()
        bv = getattr(self.app, "batch_verifier", None)
        if bv is not None and hasattr(bv, "breaker_state"):
            # the breaker state gauge is level, not flow: a clear must
            # not report an OPEN breaker as CLOSED until the next
            # transition happens to re-set it
            bv.refresh_gauge()
        # telemetry ring + scrape cursors (the epoch rotates, so a
        # scraper holding an old since= token resyncs with reset=true
        # instead of silently gapping) and the SLO sliding-window
        # state reset too — the reset contract: bench legs in one
        # process measure each window from a clean slate. Bad-sig
        # accounting still deliberately survives (it feeds the
        # per-peer drop threshold).
        tel = getattr(self.app, "telemetry", None)
        if tel is not None:
            tel.clear()
        slo = getattr(self.app, "slo", None)
        if slo is not None:
            slo.reset()
        # the adaptive controller's learned state too: knobs back to
        # config, shed probabilities to zero, decision log cleared,
        # epoch rotated — a frozen or mis-trained controller must not
        # leak tuning into the next bench leg sharing this process
        ctl = getattr(self.app, "controller", None)
        if ctl is not None:
            ctl.reset()
        # the read tier's learned hedge-trigger window resets with the
        # registry its latency timer lives in
        qsvc = getattr(self.app, "query_service", None)
        if qsvc is not None:
            qsvc.reset_stats()
        return {"status": "ok"}

    # ------------------------------------------------------ flight recorder --
    def _start_trace(self, params) -> dict:
        """Begin span recording (util/tracing.py — the Tracy-capture
        analogue): starttrace[?capacity=N] ring-buffers events until
        stoptrace/dumptrace."""
        rec = self.app.flight_recorder
        cap = params.get("capacity")
        rec.start(capacity=int(cap) if cap else None)
        return {"status": "ok", "capacity": rec._capacity}

    def _stop_trace(self, params) -> dict:
        rec = self.app.flight_recorder
        if not rec.active:
            return {"exception": "no trace is recording"}
        return {"status": "ok", **rec.stop()}

    def _dump_trace(self, params) -> dict:
        """Dump the recorded span buffer as Chrome trace-event JSON
        (load in Perfetto / chrome://tracing, or feed to
        scripts/trace_report.py). dumptrace?path=/x.json writes a file;
        without path the document is returned inline."""
        rec = self.app.flight_recorder
        doc = rec.to_chrome_trace()
        path = params.get("path")
        if path:
            # create-only ('x'): an admin GET must never be a
            # truncate-arbitrary-file primitive (the chaos route's
            # production-gate precedent; overwriting an existing file
            # fails loudly instead)
            with open(path, "x") as f:
                json.dump(doc, f)
            return {"status": "ok", "path": path,
                    "events": len(doc["traceEvents"]),
                    "dropped": rec.dropped}
        return {"trace": doc}

    def _record_start(self, params) -> dict:
        """Attach an input recorder (replay/recorder.py) and start
        capturing this node's inputs: recordstart[?path=<file>]. With
        `path` the log streams to a create-only file (torn-tail
        tolerant across a kill); without it the log buffers in memory
        for `recorddump`. Gated like `chaos`: recording captures every
        inbound frame verbatim, so a production node must not accept
        it over HTTP."""
        if not self.app.config.ALLOW_INPUT_RECORDING:
            return {"exception":
                    "input recording disabled (ALLOW_INPUT_RECORDING)"}
        if getattr(self.app, "input_recorder", None) is not None and \
                self.app.input_recorder.active:
            return {"exception": "recording already active"}
        from ..replay.recorder import InputRecorder
        rec = InputRecorder(self.app, path=params.get("path"))
        rec.begin()     # open("xb") — never truncates an existing file
        self.app.input_recorder = rec
        out = {"status": "recording", "node": rec.node_hex}
        if rec.path is not None:
            out["path"] = rec.path
        return out

    def _record_stop(self, params) -> dict:
        """Write the END marker and detach: recordstop. The stats echo
        what was captured; a file-backed log is complete on disk."""
        if not self.app.config.ALLOW_INPUT_RECORDING:
            return {"exception":
                    "input recording disabled (ALLOW_INPUT_RECORDING)"}
        rec = getattr(self.app, "input_recorder", None)
        if rec is None or not rec.active:
            return {"exception": "no active recording"}
        stats = rec.finish(reason="recordstop")
        return {"status": "stopped", **stats}

    def _record_dump(self, params) -> dict:
        """Dump an in-memory recording: recorddump?path=<file>. Like
        `dumptrace`, create-only — the admin API must never be a
        truncate-arbitrary-file primitive. Valid after recordstop (the
        buffer survives until the next recordstart)."""
        if not self.app.config.ALLOW_INPUT_RECORDING:
            return {"exception":
                    "input recording disabled (ALLOW_INPUT_RECORDING)"}
        rec = getattr(self.app, "input_recorder", None)
        if rec is None:
            return {"exception": "nothing recorded"}
        if rec.active:
            return {"exception": "recording still active (recordstop "
                    "first, or recordstart?path= to stream to disk)"}
        if rec.path is not None:
            return {"exception": "recording already streamed to "
                    f"{rec.path}"}
        path = params.get("path")
        if not path:
            return {"exception": "missing 'path' parameter"}
        data = rec.to_bytes()
        with open(path, "xb") as f:
            f.write(data)
        return {"status": "ok", "path": path, "bytes": len(data)}

    def _tx(self, params) -> dict:
        """Submit a base64-XDR TransactionEnvelope (reference:
        CommandHandler::tx :115)."""
        blob = params.get("blob")
        if not blob:
            return {"exception": "missing 'blob' parameter"}
        try:
            raw = base64.b64decode(blob, validate=True)
            env = TransactionEnvelope.from_bytes(raw)
        except (binascii.Error, Exception) as e:
            return {"exception": f"malformed envelope: {e}"}
        from ..tx.frame import make_frame
        frame = make_frame(env, self.app.config.network_id())
        rec = getattr(self.app, "input_recorder", None)
        if rec is not None and rec.active:
            rec.record_inject([raw], direct=True)
        res = self.app.herder.recv_transaction(frame)
        out = {"status": _add_result_name(res)}
        if res == AddResult.ADD_STATUS_ERROR and frame.result is not None:
            out["error"] = base64.b64encode(
                frame.result.to_bytes()).decode()
        return out

    def _manual_close(self, params) -> dict:
        self.app.manual_close()
        return {"status": "Manually triggered a ledger close with sequence "
                          f"number {self.app.ledger_manager.get_last_closed_ledger_num()}"}

    def _upgrades(self, params) -> dict:
        """reference: CommandHandler::upgrades — mode=get|set|clear."""
        from ..herder.upgrades import UpgradeParameters
        mode = params.get("mode", "get")
        up = self.app.herder.upgrades
        if mode == "get":
            import base64
            p = up.get_parameters()
            return {"upgrades": {
                "upgradetime": p.upgrade_time,
                "protocolversion": p.protocol_version,
                "basefee": p.base_fee,
                "basereserve": p.base_reserve,
                "maxtxsetsize": p.max_tx_set_size,
                "maxsorobantxsetsize": p.max_soroban_tx_set_size,
                "configupgradesetkey":
                    base64.b64encode(
                        p.config_upgrade_set_key.to_bytes()).decode()
                    if p.config_upgrade_set_key is not None else None,
            }}
        if mode == "clear":
            up.set_parameters(UpgradeParameters())
            return {"status": "ok"}
        if mode == "set":
            def _opt(name):
                v = params.get(name)
                return int(v) if v is not None else None
            cfg_key = None
            if params.get("configupgradesetkey"):
                import base64
                from ..xdr.contract import ConfigUpgradeSetKey
                cfg_key = ConfigUpgradeSetKey.from_bytes(
                    base64.b64decode(params["configupgradesetkey"],
                                     validate=True))
            up.set_parameters(UpgradeParameters(
                upgrade_time=int(params.get("upgradetime", 0)),
                protocol_version=_opt("protocolversion"),
                base_fee=_opt("basefee"),
                base_reserve=_opt("basereserve"),
                max_tx_set_size=_opt("maxtxsetsize"),
                max_soroban_tx_set_size=_opt("maxsorobantxsetsize"),
                config_upgrade_set_key=cfg_key))
            return {"status": "ok"}
        return {"exception": f"unknown mode: {mode}"}

    def _log_level(self, params) -> dict:
        level = params.get("level")
        if not level:
            return {"exception": "missing 'level'"}
        set_log_level(level, params.get("partition"))
        return {"status": "ok"}

    def _peers(self, params) -> dict:
        overlay = getattr(self.app, "overlay_manager", None)
        if overlay is None:
            return {"authenticated_peers": {"inbound": [], "outbound": []}}
        return {"authenticated_peers": overlay.peers_json()}

    def _quorum(self, params) -> dict:
        """reference: CommandHandler::quorum; ?transitive=true also runs
        the quorum-intersection analysis."""
        herder = self.app.herder
        analyze = (params or {}).get("transitive", "") in ("true", "1")
        if hasattr(herder, "quorum_json"):
            return herder.quorum_json(analyze=analyze)
        return {"node": "unknown", "qset": {}}

    def _maintenance(self, params) -> dict:
        count = int(params.get("count", 50000))
        deleted = self.app.maintainer.perform_maintenance(count)
        return {"status": "ok", "deleted": deleted}

    def _set_cursor(self, params) -> dict:
        """reference: CommandHandler::setcursor (ExternalQueue)."""
        resid = params.get("id")
        cursor = params.get("cursor")
        if not resid or cursor is None:
            return {"exception": "missing id or cursor"}
        self.app.maintainer.external_queue.set_cursor_for_resource(
            resid, int(cursor))
        return {"status": "ok"}

    def _get_cursor(self, params) -> dict:
        return {"cursors": self.app.maintainer.external_queue.get_cursor(
            params.get("id"))}

    def _drop_cursor(self, params) -> dict:
        resid = params.get("id")
        if not resid:
            return {"exception": "missing id"}
        self.app.maintainer.external_queue.delete_cursor(resid)
        return {"status": "ok"}

    def _self_check(self, params) -> dict:
        from .self_check import self_check
        ok, report = self_check(self.app)
        return {"status": "ok" if ok else "failed", "report": report}

    def _survey_topology(self, params) -> dict:
        """reference: CommandHandler surveytopology — node param is a
        strkey public key."""
        from ..crypto.strkey import StrKey
        node = params.get("node")
        if not node or self.app.overlay_manager is None:
            return {"exception": "missing node or no overlay"}
        self.app.overlay_manager.survey_manager.survey_peer(
            StrKey.decode_ed25519_public(node))
        return {"status": "ok"}

    def _get_survey_result(self, params) -> dict:
        if self.app.overlay_manager is None:
            return {"exception": "no overlay"}
        return {"topology":
                self.app.overlay_manager.survey_manager.results_json()}

    def _ban_and_drop(self, raw: bytes, reason: str,
                      ban: bool) -> int:
        """Shared by ban/droppeer: optionally ban, then drop matching
        authenticated peers."""
        if ban:
            self.app.overlay_manager.ban_manager.ban_node(raw)
        dropped = 0
        for peer in self.app.overlay_manager.get_authenticated_peers():
            if peer.peer_id == raw:
                peer.drop(reason)
                dropped += 1
        return dropped

    def _ban(self, params) -> dict:
        from ..crypto.strkey import StrKey
        node = params.get("node")
        if not node or self.app.overlay_manager is None:
            return {"exception": "missing node or no overlay"}
        self._ban_and_drop(StrKey.decode_ed25519_public(node),
                           "banned", ban=True)
        return {"status": "ok"}

    def _unban(self, params) -> dict:
        from ..crypto.strkey import StrKey
        node = params.get("node")
        if not node or self.app.overlay_manager is None:
            return {"exception": "missing node or no overlay"}
        self.app.overlay_manager.ban_manager.unban_node(
            StrKey.decode_ed25519_public(node))
        return {"status": "ok"}

    def _bans(self, params) -> dict:
        from ..crypto.strkey import StrKey
        if self.app.overlay_manager is None:
            return {"exception": "no overlay"}
        return {"bans": [StrKey.encode_ed25519_public(n) for n in
                         self.app.overlay_manager.ban_manager
                         .banned_nodes()]}

    def _connect(self, params) -> dict:
        """reference: CommandHandler::connect — dial peer=ip&port=N."""
        peer_ip = params.get("peer")
        port = params.get("port")
        if not peer_ip or not port or self.app.overlay_manager is None:
            return {"exception": "missing peer/port or no overlay"}
        from ..overlay.tcp_peer import connect_to
        self.app.overlay_manager.peer_manager.ensure_exists(
            peer_ip, int(port))
        connect_to(self.app.overlay_manager, peer_ip, int(port))
        return {"status": "ok"}


    def _drop_peer(self, params) -> dict:
        """reference: CommandHandler::dropPeer — droppeer?node=ID[&ban=1]."""
        from ..crypto.strkey import StrKey
        node = params.get("node")
        if not node or self.app.overlay_manager is None:
            return {"exception":
                    "Must specify at least peer id: droppeer?node=NODE_ID"}
        dropped = self._ban_and_drop(
            StrKey.decode_ed25519_public(node), "dropped by admin",
            ban=params.get("ban") in ("1", "true"))
        return {"status": "ok", "dropped": dropped}

    def _scp_info(self, params) -> dict:
        """reference: CommandHandler::scpInfo — per-slot consensus state
        (scp?limit=N)."""
        herder = self.app.herder
        if herder.scp is None:
            return {"exception": "node has no SCP (no NODE_SEED)"}
        limit = int(params.get("limit", "2"))
        slots = {}
        for idx in sorted(herder.scp.known_slots, reverse=True)[:limit]:
            slot = herder.scp.known_slots[idx]
            bp, np_ = slot.ballot, slot.nomination
            slots[str(idx)] = {
                "phase": bp.phase.name,
                "ballot_counter": bp.current.counter
                if bp.current is not None else 0,
                "heard_from": len(bp.latest_envelopes),
                "nomination": {
                    "votes": len(np_.votes),
                    "accepted": len(np_.accepted),
                    "candidates": len(np_.candidates),
                },
                "fully_validated": slot.is_fully_validated(),
            }
        from ..crypto.strkey import StrKey
        return {"scp": {"you": StrKey.encode_ed25519_public(
                            self.app.config.node_id()),
                        "slots": slots}}

    def _get_ledger_entry(self, params) -> dict:
        """reference: CommandHandler::getLedgerEntry :709 —
        getledgerentry?key=<base64 LedgerKey XDR>."""
        import base64
        from ..ledger.ledger_txn import LedgerTxn
        from ..xdr.ledger_entries import LedgerKey
        key_b64 = params.get("key")
        if not key_b64:
            return {"exception": "Must specify ledger key: "
                    "getledgerentry?key=<LedgerKey in base64 XDR format>"}
        key = LedgerKey.from_bytes(base64.b64decode(key_b64,
                                                    validate=True))
        out = {"ledger":
               self.app.ledger_manager.get_last_closed_ledger_num()}
        with LedgerTxn(self.app.ledger_manager.root) as ltx:
            le = ltx.load_without_record(key)
            if le is not None:
                out["state"] = "live"
                out["entry"] = base64.b64encode(le.to_bytes()).decode()
            else:
                out["state"] = "dead"
        return out

    # ------------------------------------------------------- read tier --
    def _account(self, params) -> dict:
        """account?id=<G... strkey | 64-char hex> — snapshot-consistent
        account read through the query-worker pool (docs/READ_PATH.md).
        Every answer names the exact closed ledger it was read at."""
        import base64
        from ..crypto.strkey import StrKey
        acct = params.get("id")
        if not acct:
            return {"exception": "Must specify account: "
                    "account?id=<strkey or hex account id>"}
        if len(acct) == 64:
            try:
                raw = bytes.fromhex(acct)
            except ValueError:
                return {"exception": f"bad account id: {acct}"}
        else:
            raw = StrKey.decode_ed25519_public(acct)
        deadline = params.get("deadline_ms")
        res = self.app.query_service.query_account(
            raw, deadline_ms=float(deadline) if deadline else None)
        out = {"ledger_seq": res.get("ledger_seq"),
               "found": res.get("found", False),
               "latency_ms": res.get("latency_ms")}
        for k in ("shed", "timeout", "error"):
            if k in res:
                out[k] = res[k]
        if res.get("entry_xdr"):
            out["entry"] = base64.b64encode(res["entry_xdr"]).decode()
        return out

    def _tx_status(self, params) -> dict:
        """txstatus?hash=<64-char hex envelope hash (tx.full_hash(),
        the completion stream's result-pair key)> — result XDR + the
        ledger it applied in, from the completion-fed status ring."""
        import base64
        h = params.get("hash")
        if not h:
            return {"exception": "Must specify tx hash: "
                    "txstatus?hash=<hex transaction hash>"}
        try:
            raw = bytes.fromhex(h)
        except ValueError:
            return {"exception": f"bad tx hash: {h}"}
        deadline = params.get("deadline_ms")
        res = self.app.query_service.query_tx_status(
            raw, deadline_ms=float(deadline) if deadline else None)
        out = {"ledger_seq": res.get("ledger_seq"),
               "found": res.get("found", False),
               "latency_ms": res.get("latency_ms")}
        for k in ("shed", "timeout", "error"):
            if k in res:
                out[k] = res[k]
        if res.get("result_xdr"):
            out["result"] = base64.b64encode(res["result_xdr"]).decode()
        return out

    def _snapshot_info(self, params) -> dict:
        """snapshotinfo — the read tier's serving state: newest
        snapshot seq, open snapshot count, pool/shed/hedge tallies."""
        snaps = self.app.snapshots.stats()
        return {"snapshot": snaps,
                "pinned_buckets":
                    len(self.app.snapshots.pinned_bucket_hashes()),
                "tx_status_entries": len(self.app.tx_status),
                "service": self.app.query_service.stats()}

    def _generate_load(self, params) -> dict:
        """reference: CommandHandler::generateLoad — synthesize load
        (generateload?mode=create|pay|zipf&accounts=N&txs=N
        [&exponent=F]). `zipf` is the hot-account skew mode (the Zipfian
        loadgen): rank-weighted
        source/destination draws, reproducible per node."""
        from ..simulation.load_generator import LoadGenerator
        mode = params.get("mode", "create")
        if getattr(self, "_load_generator", None) is None:
            self._load_generator = LoadGenerator(self.app)
        lg = self._load_generator
        if mode == "create":
            n = int(params.get("accounts", "100"))
            created = lg.generate_accounts(n)
            return {"status": "ok", "mode": mode, "submitted": created}
        if mode in ("pay", "zipf"):
            if len(lg.accounts) < 2:
                return {"exception": "run generateload?mode=create and "
                        "close a ledger first"}
            n = int(params.get("txs", "100"))
            lg.sync_account_seqs()  # learn seqnums from the last close
            if mode == "zipf":
                submitted = lg.generate_payments_zipf(
                    n, exponent=float(params.get("exponent", "1.0")))
            else:
                submitted = lg.generate_payments(n)
            return {"status": "ok", "mode": mode, "submitted": submitted}
        return {"exception": f"unknown load mode: {mode}"}

    def _perf(self, params) -> dict:
        """Zone-timing report (our Tracy analogue, SURVEY.md §5.1);
        perf?reset=1 clears this node's zones."""
        report = self.app.perf.report()
        if params.get("reset") in ("1", "true"):
            self.app.perf.reset()
        return {"perf": report}

    def _chaos(self, params) -> dict:
        """Runtime chaos control: chaos?mode=status|install|clear.
        install takes seed=N and schedule=<JSON list of fault specs>
        (see docs/CHAOS.md). status is always served; install/clear
        require ALLOW_CHAOS_INJECTION — a production node must not
        accept fault injection over HTTP."""
        from ..util import chaos
        mode = params.get("mode", "status")
        if mode == "status":
            return {"chaos": chaos.status()}
        if not self.app.config.ALLOW_CHAOS_INJECTION:
            return {"exception":
                    "chaos injection disabled (ALLOW_CHAOS_INJECTION)"}
        if mode == "install":
            seed = int(params.get("seed", "0"))
            schedule = chaos.schedule_from_json(
                json.loads(params.get("schedule", "[]")))
            chaos.install(chaos.ChaosEngine(seed, schedule))
            return {"status": "ok", "chaos": chaos.status()}
        if mode == "clear":
            chaos.uninstall()
            return {"status": "ok"}
        return {"exception": f"unknown chaos mode: {mode}"}

    def _backend_status(self, params) -> dict:
        """Device-backend supervisor state (ops/backend_supervisor.py):
        aggregate breaker state, the surviving-mesh summary, and
        per-device rows (state, consecutive failures, probe ages,
        dispatch/skip counters, quarantined handles).
        backendstatus?action=trip|reset[&device=N] forces a breaker
        transition — whole-mesh, or one device so a single chip can be
        drained/readmitted — gated behind ALLOW_CHAOS_INJECTION like
        the chaos route: a production node must not accept forced
        degradation over HTTP. Plain status is always served; the
        cluster harness (simulation/cluster.py) polls it per node into
        CLUSTER artifacts."""
        sup = getattr(self.app, "batch_verifier", None)
        if sup is None or not hasattr(sup, "breaker_state"):
            return {"exception": "no supervised device backend "
                    "(SIGNATURE_VERIFY_BACKEND is not cuda or tpu)"}
        action = params.get("action")
        if action:
            if not self.app.config.ALLOW_CHAOS_INJECTION:
                return {"exception": "backend actions disabled "
                        "(ALLOW_CHAOS_INJECTION)"}
            device = params.get("device")
            try:
                device = int(device) if device is not None else None
                if device is not None and not \
                        0 <= device < sup.mesh_status()["devices"]:
                    raise ValueError(device)
            except (TypeError, ValueError):
                return {"exception": f"bad device index: {device!r}"}
            if action == "trip":
                sup.force_trip(device=device)
            elif action == "reset":
                sup.force_reset(device=device)
            else:
                return {"exception": f"unknown action: {action}"}
        return {"backend": sup.status()}

    def _timeseries(self, params) -> dict:
        """Telemetry time-series scrape (util/timeseries.py):
        `timeseries[?since=<cursor>][&limit=N][&summary=1]`. The reply
        carries an opaque `cursor` token; passing it back as `since=`
        returns only newer samples — incremental scraping for the
        cluster harness. `reset: true` means the epoch changed
        (restart / clearmetrics) or the continuation point fell off
        the bounded ring, and the buffer was served from the start
        instead. `limit=N` serves the OLDEST N pending samples with
        the cursor pointing at the last one served (`truncated:
        true`), so chained limited scrapes walk the series gap-free.
        `summary=1` returns the bounded series summary (the bench
        artifact form) rather than raw samples."""
        tel = self.app.telemetry
        if params.get("summary") in ("1", "true"):
            from ..util.timeseries import summarize_samples
            return {"timeseries": {
                "epoch": tel.series.epoch,
                "period_s": tel.period_s,
                "summary": summarize_samples(tel.series.samples())}}
        limit = params.get("limit")
        doc = tel.series.to_doc(since=params.get("since"),
                                limit=int(limit) if limit else None)
        doc["period_s"] = tel.period_s
        return {"timeseries": doc}

    def _slo(self, params) -> dict:
        """SLO watchdog status (ops/slo.py): per-rule OK/WARN/BREACH
        verdict, last value vs threshold, breach tallies and the
        composite `overall` — evaluated continuously over the
        telemetry series, this route just reads the current state."""
        return {"slo": self.app.slo.status()}

    def _controller(self, params) -> dict:
        """Adaptive control plane (ops/controller.py): live knob
        values vs config, shed probabilities + per-gate drop tallies,
        the learned close-capacity estimate, and the decision-log
        tail. `controller?action=freeze` pins every knob/shed level
        as-is, `?action=reset` restores config knobs and zeroes the
        learned state (epoch rotates) — both gated behind
        ALLOW_CHAOS_INJECTION like the chaos/backendstatus actions: a
        production node must not accept control-plane overrides over
        HTTP. Plain status is always served; simulation/cluster.py
        polls it into CLUSTER artifacts."""
        ctl = self.app.controller
        action = params.get("action")
        if action:
            if not self.app.config.ALLOW_CHAOS_INJECTION:
                return {"exception": "controller actions disabled "
                        "(ALLOW_CHAOS_INJECTION)"}
            if action == "freeze":
                ctl.freeze()
            elif action == "reset":
                ctl.reset()
            else:
                return {"exception": f"unknown action: {action}"}
        return {"controller": ctl.status()}

    def _cluster_status(self, params) -> dict:
        """Structured per-node health/SLO snapshot (mesh observatory):
        one JSON document a cluster harness can collect from every
        node over HTTP and judge without scraping full metrics —
        ledger position, close latency, tx e2e quantiles, flood
        redundancy, peer accounting, breaker state, and a composite
        `healthy` verdict. ROADMAP item 4's multi-process simulation
        driver collects its per-node verdicts from exactly this."""
        from .application import _state_name
        from ..util.timeseries import timer_quantiles
        app = self.app
        lm = app.ledger_manager

        def timer_ms(name: str) -> dict:
            # the shared per-timer read discipline (util/timeseries.py
            # — the telemetry sampler reads the same shape)
            return timer_quantiles(app.metrics, name)

        peers = []
        drop_reasons = {}
        bad_sig = duplicates = 0
        if app.overlay_manager is not None:
            peers = app.overlay_manager.get_authenticated_peers()
            drop_reasons = dict(app.overlay_manager.drop_reasons)
            bad_sig = sum(p.bad_sig_drops for p in peers)
            duplicates = sum(p.duplicate_messages for p in peers)
        backend = None
        sup = getattr(app, "batch_verifier", None)
        if sup is not None and hasattr(sup, "breaker_state"):
            backend = {"state": sup.state,
                       "failures": sup.status()["failures"]}
        from ..crypto.strkey import StrKey
        out = {
            "node": StrKey.encode_ed25519_public(app.config.node_id())
            if app.config.NODE_SEED is not None else None,
            "label": app.flight_recorder.label or "node",
            "state": _state_name(app.state),
            "herder_state": app.herder.get_state().name,
            "ledger": {
                "num": lm.get_last_closed_ledger_num(),
                "hash": lm.get_last_closed_ledger_hash().hex(),
            },
            "close": timer_ms("ledger.ledger.close"),
            "tx_e2e": timer_ms("ledger.transaction.e2e"),
            "slot_phases": {
                p: timer_ms("scp.slot." + p)
                for p in ("nominate", "prepare", "confirm", "total")},
            "flood": app.propagation.report()
            if getattr(app, "propagation", None) is not None else {},
            "peers": {"authenticated": len(peers),
                      "drop_reasons": drop_reasons,
                      "bad_sig_drops": bad_sig,
                      "duplicates": duplicates},
            "backend": backend,
            "pending_txs": app.herder.tx_queue.size_txs(),
        }
        from .application import AppState
        out["healthy"] = bool(
            app.state == AppState.APP_SYNCED_STATE
            and (backend is None or backend["state"] == "CLOSED"))
        headers = params.get("headers")
        if headers:
            # clusterstatus?headers=A-B: per-seq header hashes for the
            # requested range, so the multi-process harness can judge
            # byte-identical honest-survivor chains over HTTP without
            # a second route (simulation/cluster.py verdicts)
            lo, _, hi = headers.partition("-")
            lo = max(2, int(lo))
            hi = int(hi) if hi else lm.get_last_closed_ledger_num()
            rows = app.database.query_all(
                "SELECT ledgerseq, ledgerhash FROM ledgerheaders "
                "WHERE ledgerseq BETWEEN ? AND ?", (lo, hi))
            out["headers"] = {str(seq): bytes(h).hex()
                              for seq, h in rows}
        return {"clusterstatus": out}


def _add_result_name(res: AddResult) -> str:
    # reference: CommandHandler formats TransactionQueue::AddResult
    return {
        AddResult.ADD_STATUS_PENDING: "PENDING",
        AddResult.ADD_STATUS_DUPLICATE: "DUPLICATE",
        AddResult.ADD_STATUS_ERROR: "ERROR",
        AddResult.ADD_STATUS_TRY_AGAIN_LATER: "TRY_AGAIN_LATER",
        AddResult.ADD_STATUS_FILTERED: "FILTERED",
    }[res]


def run_http_server(handler: CommandHandler, port: int,
                    public: bool = False,
                    max_client: int = 128,
                    clock=None) -> "threading.Thread":
    """Serve the admin API (reference: CommandHandler ctor binds libhttp
    on 127.0.0.1:HTTP_PORT unless PUBLIC_HTTP_PORT; HTTP_MAX_CLIENT
    bounds the accept backlog).

    With `clock` (the `run` command passes the app's VirtualClock),
    each request is POSTED onto the main crank loop and the socket
    thread waits for the result — the single-main-thread discipline
    the reference keeps by running libhttp on the main io_context.
    Without it (socketless tests, ad-hoc servers with their own crank
    arrangements) commands run directly on the handler thread, which
    is only safe while nothing cranks concurrently: the multi-process
    cluster harness found `generateload`'s LedgerTxn racing a
    concurrent close's trim_invalid ("parent already has an open child
    LedgerTxn") when dispatch stayed on the socket thread."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # thread-domain: http
            from ..util import threads
            if threads.CHECK:
                threads.bind("http")
            parsed = urlparse(self.path)
            command = parsed.path.strip("/")
            params = {k: v[0] for k, v in parse_qs(parsed.query).items()}
            if clock is None:
                out = handler.handle(command, params)
            elif clock.stopped:
                # a job posted after clock.stop() would never run and
                # would pin this socket thread for the full timeout
                out = {"exception": "node is shutting down"}
            else:
                box: dict = {}
                done = threading.Event()

                def job():
                    try:
                        box["out"] = handler.handle(command, params)
                    finally:
                        done.set()

                clock.post(job)
                if not done.wait(30.0):
                    # the job stays queued: it may STILL execute once
                    # the loop unblocks — callers must not read this
                    # as "not executed" and retry a non-idempotent
                    # command
                    box.setdefault(
                        "out",
                        {"exception":
                         "main loop did not service the request "
                         "within 30s (the command may still execute; "
                         "do not blindly retry)"})
                out = box.get("out") or {
                    "exception": "request dispatch failed"}
            if isinstance(out, dict) and "_raw_body" in out:
                # non-JSON responses (Prometheus text exposition)
                body = out["_raw_body"].encode()
                ctype = out.get("_content_type", "text/plain")
            else:
                body = json.dumps(out).encode()
                ctype = "application/json"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet
            pass

    host = "" if public else "127.0.0.1"

    class _Server(ThreadingHTTPServer):
        request_queue_size = max(1, max_client)

    server = _Server((host, port), _Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.server = server  # type: ignore[attr-defined]
    thread.start()
    return thread
