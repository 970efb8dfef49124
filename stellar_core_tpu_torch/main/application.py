"""Application — the facade owning every subsystem.

Reference: src/main/ApplicationImpl.{h,cpp} — one object owning the
clock, config, database, bucket manager, ledger manager, herder, overlay,
history, metrics, and the admin command handler (ApplicationImpl.h:129-200).
`start()` (:782) restores the last known ledger and brings the node in
sync; the run loop cranks the VirtualClock until stopped.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

from ..bucket.manager import BucketManager
from ..db.database import Database
from ..herder.herder import Herder
from ..invariant.invariants import register_default_invariants
from ..invariant.manager import InvariantManager
from ..ledger.ledger_manager import LedgerManager
from ..util.logging import get_logger
from ..util.metrics import MetricsRegistry
from ..util.scheduler import Scheduler
from ..util.timer import ClockMode, VirtualClock
from .config import Config
from .persistent_state import PersistentState, StateEntry

log = get_logger("default")


class AppState:
    # reference: Application::State
    APP_CREATED_STATE = 0
    APP_ACQUIRING_CONSENSUS_STATE = 1
    APP_CONNECTED_STANDBY_STATE = 2
    APP_CATCHING_UP_STATE = 3
    APP_SYNCED_STATE = 4
    APP_STOPPING_STATE = 5


class Application:
    @classmethod
    def create(cls, clock: VirtualClock, config: Config,
               new_db: bool = True) -> "Application":
        return cls(clock, config, new_db=new_db)

    def __init__(self, clock: VirtualClock, config: Config,
                 new_db: bool = True):
        # process-wide, first app wins: keep CPython's automatic
        # full-heap (gen2) collections off the close/crank paths —
        # they scan the whole live set for up to seconds and reclaim
        # ~nothing here; the Maintainer cron runs the explicit pass
        # instead (util/gcpolicy.py has the measurements)
        from ..util import gcpolicy
        gcpolicy.install()
        self.clock = clock
        self.config = config
        self.state = AppState.APP_CREATED_STATE
        self.metrics = MetricsRegistry(
            window_minutes=config.HISTOGRAM_WINDOW_SIZE or None)
        from ..util.perf import ZoneRegistry
        from ..util.tracing import FlightRecorder
        self.perf = ZoneRegistry()
        # flight recorder (util/tracing.py): idle until the admin
        # `starttrace` route / bench --trace starts it; the perf zones
        # route their begin/end events through it while recording
        self.flight_recorder = FlightRecorder()
        self.perf.tracer = self.flight_recorder
        # input recorder (replay/recorder.py): attached by the
        # `recordstart` admin route or a Simulation driver; None means
        # every recording hook is a single attribute check
        self.input_recorder = None
        self.scheduler = Scheduler()

        from ..db.database import create_database
        self.database = create_database(config, metrics=self.metrics)
        if new_db or config.is_in_memory_mode():
            self.database.initialize()
        else:
            self.database.upgrade_to_current_schema()
        self.persistent_state = PersistentState(self.database)
        self.persistent_state.set(StateEntry.NETWORK_PASSPHRASE,
                                  config.NETWORK_PASSPHRASE)

        bucket_dir = config.BUCKET_DIR_PATH
        if bucket_dir is None:
            self._tmp_bucket_dir = tempfile.TemporaryDirectory(
                prefix="buckets-")
            bucket_dir = self._tmp_bucket_dir.name
        else:
            self._tmp_bucket_dir = None
            os.makedirs(bucket_dir, exist_ok=True)
        # process-global level cadence (consensus-affecting, testing
        # only). Only ever SET here: a constructor must not flip the
        # cadence under an already-live app's bucket list — tests that
        # enable it reset it themselves when done
        if config.ARTIFICIALLY_REDUCE_MERGE_COUNTS_FOR_TESTING:
            from ..bucket.bucket_list import set_reduced_merge_counts
            set_reduced_merge_counts(True)
        self.bucket_manager = BucketManager(
            bucket_dir, num_workers=config.WORKER_THREADS,
            pessimize_merges=config.ARTIFICIALLY_PESSIMIZE_MERGES_FOR_TESTING,
            disable_gc=config.DISABLE_BUCKET_GC,
            disable_xdr_fsync=config.DISABLE_XDR_FSYNC)
        self.bucket_manager.bucket_list.perf = self.perf

        self.invariant_manager = InvariantManager(metrics=self.metrics)
        if config.INVARIANT_CHECKS:
            register_default_invariants(self.invariant_manager)

        meta_stream = None
        self._meta_file = None
        if config.METADATA_OUTPUT_STREAM:
            from ..util.xdr_stream import write_record
            self._meta_file = open(config.METADATA_OUTPUT_STREAM, "ab")

            def meta_stream(meta, _f=self._meta_file):
                write_record(_f, meta.to_bytes())
                _f.flush()

        self.ledger_manager = LedgerManager(
            db=self.database,
            bucket_manager=self.bucket_manager,
            invariants=self.invariant_manager,
            metrics=self.metrics,
            meta_stream=meta_stream,
            entry_cache_size=config.ENTRY_CACHE_SIZE,
            in_memory_ledger=config.MODE_USES_IN_MEMORY_LEDGER)

        self.ledger_manager.perf = self.perf
        if config.NODE_SEED is not None:
            # chaos fault schedules target nodes by id (util/chaos.py)
            self.ledger_manager.chaos_label = config.node_id().hex()
            # trace process-track label + pid separate the nodes of a
            # multi-node in-process simulation in Perfetto
            self.flight_recorder.label = config.node_id().hex()[:8]
            self.flight_recorder.pid = 1 + (config.PEER_PORT or 0)
        self.ledger_manager.stores_history_misc = \
            config.MODE_STORES_HISTORY_MISC
        self.ledger_manager.halt_on_internal_error = \
            config.HALT_ON_INTERNAL_TRANSACTION_ERROR
        self.ledger_manager.internal_error_min_protocol = \
            config.LEDGER_PROTOCOL_MIN_VERSION_INTERNAL_ERROR_REPORT
        self.ledger_manager.stores_history_ledgerheaders = \
            config.MODE_STORES_HISTORY_LEDGERHEADERS
        self.ledger_manager.delay_meta = \
            config.EXPERIMENTAL_PRECAUTION_DELAY_META
        if config.TESTING_SOROBAN_HIGH_LIMIT_OVERRIDE:
            self.ledger_manager.soroban_high_limits = True
        if config.ARTIFICIALLY_REPLAY_WITH_NEWEST_BUCKET_LOGIC_FOR_TESTING:
            from ..bucket.bucket import set_newest_merge_logic
            set_newest_merge_logic(True)
        if config.EXPERIMENTAL_BUCKETLIST_DB_PERSIST_INDEX:
            from ..bucket.bucket_index import set_persist_index
            set_persist_index(True)
        # BucketIndex tuning is process-global; only a NON-DEFAULT
        # config ever sets it (an unrelated default-config app must not
        # retune live apps' lazily-built indexes — tests that tune it
        # reset it themselves)
        if (config.EXPERIMENTAL_BUCKETLIST_DB_INDEX_CUTOFF,
                config.EXPERIMENTAL_BUCKETLIST_DB_INDEX_PAGE_SIZE_EXPONENT
                ) != (20, 14):
            from ..bucket.bucket_index import configure_index
            configure_index(
                cutoff_mb=config.EXPERIMENTAL_BUCKETLIST_DB_INDEX_CUTOFF,
                page_size_exponent=config.
                EXPERIMENTAL_BUCKETLIST_DB_INDEX_PAGE_SIZE_EXPONENT)
        if config.BEST_OFFER_DEBUGGING_ENABLED and \
                hasattr(self.ledger_manager.root, "best_offer_debugging"):
            self.ledger_manager.root.best_offer_debugging = True
        if config.OVERRIDE_EVICTION_PARAMS_FOR_TESTING:
            self.ledger_manager.archival_overrides = {
                "evictionScanSize": config.TESTING_EVICTION_SCAN_SIZE,
                "maxEntriesToArchive":
                    config.TESTING_MAX_ENTRIES_TO_ARCHIVE,
                "minPersistentTTL":
                    config.TESTING_MINIMUM_PERSISTENT_ENTRY_LIFETIME,
                "startingEvictionScanLevel":
                    config.TESTING_STARTING_EVICTION_SCAN_LEVEL,
            }
        root = self.ledger_manager.root
        if hasattr(root, "prefetch_batch"):
            root.prefetch_batch = config.PREFETCH_BATCH_SIZE
            root.max_batch_write_count = config.MAX_BATCH_WRITE_COUNT
            root.max_batch_write_bytes = config.MAX_BATCH_WRITE_BYTES
        # off-consensus diagnostic events into V3 meta (reference:
        # ENABLE_SOROBAN_DIAGNOSTIC_EVENTS)
        self.ledger_manager.root.soroban_diagnostics = \
            config.ENABLE_SOROBAN_DIAGNOSTIC_EVENTS
        if config.OP_APPLY_SLEEP_TIME_WEIGHT_FOR_TESTING:
            weights = list(config.OP_APPLY_SLEEP_TIME_WEIGHT_FOR_TESTING)
            durations = list(
                config.OP_APPLY_SLEEP_TIME_DURATION_FOR_TESTING)
            if len(weights) != len(durations) or sum(weights) <= 0 or \
                    any(w < 0 for w in weights):
                raise ValueError(
                    "OP_APPLY_SLEEP_TIME_WEIGHT/_DURATION_FOR_TESTING "
                    "must be equal-length with positive total weight")
            self.ledger_manager.apply_sleep = (weights, durations)
        # conflict-staged parallel apply (ledger/parallel_apply.py):
        # APPLY_PARALLEL=0 is the sequential fallback knob
        self.ledger_manager.apply_parallel = config.APPLY_PARALLEL
        self.ledger_manager.apply_parallel_min_txs = \
            config.APPLY_PARALLEL_MIN_TXS
        if config.EXPERIMENTAL_BUCKETLIST_DB:
            # serve entry loads from the bucket indexes (SQL keeps
            # offers + remains the fallback store; reference:
            # EXPERIMENTAL_BUCKETLIST_DB, bucket/readme.md:55-105)
            root = self.ledger_manager.root
            if hasattr(root, "serve_from_bucket_list"):
                root.serve_from_bucket_list(
                    self.bucket_manager.bucket_list)
        # one shared device batch verifier per app when configured — the
        # herder's txset validation and catchup's checkpoint
        # prevalidation both feed it (SURVEY.md §3.2/§3.3 collection
        # points; BASELINE.md configs #2/#3)
        self.batch_verifier = None
        self.verify_service = None
        if config.SIGNATURE_VERIFY_BACKEND in ("cuda", "tpu"):
            # the device verifier rides behind the backend supervisor
            # (ops/backend_supervisor.py): a circuit breaker + hung-
            # dispatch watchdog shared by EVERY device caller — verify
            # service, txset prevalidator, catchup, self_check — so a
            # dead/flapping/hung device degrades to native verify
            # without per-flush failure latency (docs/ROBUSTNESS.md)
            from ..ops.backend_supervisor import BackendSupervisor
            self.batch_verifier = BackendSupervisor(
                self._make_batch_verifier(), clock=clock,
                metrics=self.metrics, perf=self.perf,
                failure_threshold=config.VERIFY_BREAKER_FAILURE_THRESHOLD,
                dispatch_deadline_ms=config.VERIFY_DISPATCH_DEADLINE_MS,
                probe_base_ms=config.VERIFY_BREAKER_PROBE_BASE_MS,
                probe_max_ms=config.VERIFY_BREAKER_PROBE_MAX_MS,
                canary_batch=config.VERIFY_BREAKER_CANARY_BATCH,
                jitter_seed=config.jitter_seed(),
                chaos_label=config.node_id().hex()
                if config.NODE_SEED is not None else "")
            # coalescing front-end for the LIVE per-signature paths
            # (flood admission, SCP envelopes, StellarValue sigs):
            # deadline micro-batching into the device verifier
            from ..ops.verify_service import VerifyService
            self.verify_service = VerifyService(
                self.batch_verifier, clock=clock, metrics=self.metrics,
                perf=self.perf, max_batch=config.VERIFY_MAX_BATCH,
                deadline_ms=config.VERIFY_BATCH_DEADLINE_MS)
            # staged apply prewarms each stage's signatures through the
            # same service so worker verifies hit the process cache
            self.ledger_manager.verify_service = self.verify_service
        self.herder = Herder(config, self.ledger_manager,
                             metrics=self.metrics,
                             verify=self._make_verify(),
                             batch_verifier=self.batch_verifier,
                             verify_service=self.verify_service)
        self.herder.perf = self.perf
        self.herder.set_clock(clock)
        # hash-keyed flood propagation tracking (mesh observatory,
        # overlay/propagation.py): overlay recv/send and herder
        # admit/externalize stamp into one bounded per-node map
        from ..overlay.propagation import PropagationTracker
        self.propagation = PropagationTracker(metrics=self.metrics)
        self.herder.propagation = self.propagation
        self._seed_testing_upgrades()

        from ..history.manager import HistoryManager
        from ..process.process_manager import ProcessManager
        from ..work import WorkScheduler
        self.process_manager = ProcessManager(
            self, max_concurrent=config.MAX_CONCURRENT_SUBPROCESSES)
        self.work_scheduler = WorkScheduler(self)
        self.history_manager = HistoryManager(self)
        # bucket GC must keep every bucket a queued-but-unpublished
        # checkpoint still references (the publish-queue refcount the
        # reference folds into forgetUnreferencedBuckets)
        self.bucket_manager.gc_ref_providers.append(
            self.history_manager.queued_bucket_hashes)
        self.ledger_manager.history_manager = self.history_manager
        self.ledger_manager.persistent_state = self.persistent_state
        self.ledger_manager.network_passphrase = config.NETWORK_PASSPHRASE
        if config.METADATA_DEBUG_LEDGERS:
            self.ledger_manager.meta_debug_dir = os.path.join(
                bucket_dir, "meta-debug")
            self.ledger_manager.meta_debug_ledgers = \
                config.METADATA_DEBUG_LEDGERS

        self.overlay_manager = None
        if config.NODE_SEED is not None:
            from ..overlay.manager import OverlayManager
            self.overlay_manager = OverlayManager(self)

        from ..catchup.manager import CatchupManager
        self.catchup_manager = CatchupManager(self)
        self.herder.catchup_manager = self.catchup_manager

        from .maintainer import Maintainer
        self.maintainer = Maintainer(self)

        from .command_handler import CommandHandler
        self.command_handler = CommandHandler(self)

        # telemetry time-series + SLO watchdog (util/timeseries.py,
        # ops/slo.py): a bounded ring of periodic health snapshots on
        # this app's clock, every sample judged against the declarative
        # SLO rules. The sampler's recurring timer arms in start()
        # (TELEMETRY_SAMPLE_PERIOD=0 leaves it manual — sample_now());
        # scraped via the `timeseries`/`slo` admin routes.
        from ..ops.slo import SloWatchdog, default_rules
        from ..util.timeseries import TelemetrySampler
        self.telemetry = TelemetrySampler(
            self, capacity=config.TELEMETRY_RING_CAPACITY,
            period_s=config.TELEMETRY_SAMPLE_PERIOD)
        self.slo = SloWatchdog(default_rules(config),
                               metrics=self.metrics,
                               recorder=self.flight_recorder)
        self.telemetry.observers.append(self.slo.observe)
        # adaptive control plane (ops/controller.py): closes the loop
        # over the sampler + watchdog — AIMD batch-knob search plus
        # graduated admission shedding. Its recurring tick arms in
        # start() (CONTROLLER_TICK_PERIOD=0 leaves it manual); the
        # herder's tx-submit gate and the overlay's flood-admission
        # gate consult its shed probabilities.
        from ..ops.controller import AdaptiveController
        self.controller = AdaptiveController(
            self, metrics=self.metrics, recorder=self.flight_recorder)
        self.herder.controller = self.controller

        # read-serving tier (query/): refcounted bucket-list snapshots
        # captured per close (crank-side closed_hooks), a tx-status
        # store fed from the deferred-completion stream, and the
        # bounded query-worker pool. Snapshots pin their buckets
        # against GC via the same provider mechanism the publish queue
        # uses; reads shed BEFORE writes via the controller's read
        # ladder.
        from ..query import QueryService, SnapshotManager, TxStatusStore
        self.snapshots = SnapshotManager(self.bucket_manager.bucket_list,
                                         metrics=self.metrics)
        self.bucket_manager.gc_ref_providers.append(
            self.snapshots.pinned_bucket_hashes)
        self.tx_status = TxStatusStore(
            capacity=config.QUERY_TX_STATUS_CAPACITY,
            ttl_s=config.QUERY_TX_STATUS_TTL, metrics=self.metrics)
        self.query_service = QueryService(
            self, self.snapshots, self.tx_status, self.metrics, config)
        self.ledger_manager.closed_hooks.append(
            self.snapshots.on_ledger_closed)
        self.ledger_manager.completion_hooks.append(
            self.tx_status.record_ledger)

    # -------------------------------------------------------------- wiring --
    def _make_batch_verifier(self):
        """Device-batch verifier per SIGNATURE_VERIFY_MESH: production
        multi-chip nodes shard the batch data-parallel over every
        visible card; `hybrid` folds multi-host layouts into a (host,
        card) grid so only the result gather crosses hosts. With no
        card the verifier's construction raises: the device is never
        swapped for the native verifier silently."""
        import torch

        mode = self.config.SIGNATURE_VERIFY_MESH
        min_batch = self.config.VERIFY_DEVICE_MIN_BATCH
        ndev = torch.cuda.device_count()
        if mode == "auto":
            mode = "sharded" if ndev > 1 else "single"
        if mode == "single":
            from ..ops.verifier import CudaBatchVerifier
            return CudaBatchVerifier(perf=self.perf,
                                     device_min_batch=min_batch,
                                     metrics=self.metrics)
        if mode == "sharded":
            from ..ops.verifier import ShardedBatchVerifier
            return ShardedBatchVerifier(perf=self.perf,
                                        device_min_batch=min_batch,
                                        metrics=self.metrics)
        if mode == "hybrid":
            from ..ops.multihost import HybridShardedVerifier
            return HybridShardedVerifier(perf=self.perf,
                                         device_min_batch=min_batch,
                                         metrics=self.metrics)
        raise ValueError(
            f"unknown SIGNATURE_VERIFY_MESH: {mode}")

    def _make_verify(self):
        from ..tx.signature_checker import default_verify
        backend = self.config.SIGNATURE_VERIFY_BACKEND
        if backend in ("native", "python"):
            return default_verify
        if backend in ("cuda", "tpu"):
            # per-signature fallback path; batch prevalidation is injected
            # at the txset/checkpoint collection points (SURVEY.md §3.3)
            return default_verify
        raise ValueError(f"unknown SIGNATURE_VERIFY_BACKEND: {backend}")

    def _seed_testing_upgrades(self) -> None:
        from ..herder.upgrades import UpgradeParameters
        c = self.config
        if any(v is not None for v in (
                c.TESTING_UPGRADE_LEDGER_PROTOCOL_VERSION,
                c.TESTING_UPGRADE_DESIRED_FEE,
                c.TESTING_UPGRADE_RESERVE,
                c.TESTING_UPGRADE_MAX_TX_SET_SIZE,
                c.TESTING_UPGRADE_FLAGS)):
            self.herder.upgrades.set_parameters(UpgradeParameters(
                upgrade_time=0,
                protocol_version=c.TESTING_UPGRADE_LEDGER_PROTOCOL_VERSION,
                base_fee=c.TESTING_UPGRADE_DESIRED_FEE,
                base_reserve=c.TESTING_UPGRADE_RESERVE,
                max_tx_set_size=c.TESTING_UPGRADE_MAX_TX_SET_SIZE,
                flags=c.TESTING_UPGRADE_FLAGS))

    # ----------------------------------------------------------- lifecycle --
    def start(self) -> None:
        """reference: ApplicationImpl::start :782 — load LCL or create
        genesis, then bring the herder up."""
        if not self.ledger_manager.load_last_known_ledger():
            # reference: USE_CONFIG_FOR_GENESIS — off means a protocol-0
            # genesis whose upgrades arrive through consensus voting
            genesis_protocol = self.config.LEDGER_PROTOCOL_VERSION \
                if self.config.USE_CONFIG_FOR_GENESIS else 0
            self.ledger_manager.start_new_ledger(
                self.config.network_id(), genesis_protocol)
            self.persistent_state.set(
                StateEntry.LAST_CLOSED_LEDGER,
                self.ledger_manager.get_last_closed_ledger_hash().hex())
        # boot snapshot: the read tier answers from the LCL before the
        # first close of this process ever lands
        self.snapshots.on_ledger_closed(
            self.ledger_manager.get_last_closed_ledger_header(),
            self.ledger_manager.get_last_closed_ledger_hash())
        self.herder.start()
        if self.overlay_manager is not None:
            self.overlay_manager.start()
        if self.config.FORCE_SCP and not self.config.MANUAL_CLOSE \
                and self.herder.scp is not None \
                and self.config.NODE_IS_VALIDATOR:
            self.herder.bootstrap()
        self.state = AppState.APP_SYNCED_STATE
        self.telemetry.start()
        self.controller.start()
        if self.config.AUTOMATIC_SELF_CHECK_PERIOD > 0:
            self._arm_self_check_timer()
        if self.config.AUTOMATIC_MAINTENANCE_PERIOD > 0:
            # cron-like history GC (reference: Maintainer::start with
            # AUTOMATIC_MAINTENANCE_PERIOD/_COUNT)
            self.maintainer.start(
                self.config.AUTOMATIC_MAINTENANCE_PERIOD,
                self.config.AUTOMATIC_MAINTENANCE_COUNT)
        if self.config.ARTIFICIALLY_SLEEP_MAIN_THREAD_FOR_TESTING_US > 0:
            # models a slow main thread: every crank pays the sleep
            # (reference: ARTIFICIALLY_SLEEP_MAIN_THREAD_FOR_TESTING)
            import time as _time
            us = self.config.ARTIFICIALLY_SLEEP_MAIN_THREAD_FOR_TESTING_US

            def _sleepy_poller() -> int:
                _time.sleep(us / 1e6)
                return 0

            self.clock.add_io_poller(_sleepy_poller)
        log.info("application started at ledger %d",
                 self.ledger_manager.get_last_closed_ledger_num())

    def _arm_self_check_timer(self) -> None:
        """Recurring background self-check (reference: scheduleSelfCheck,
        ApplicationImpl.cpp:823-826). The automatic run is bounded (short
        crypto bench, recent-headers-only rehash) so a firing cannot
        stall the single-threaded crank loop for long."""
        from ..util.timer import VirtualTimer
        period = self.config.AUTOMATIC_SELF_CHECK_PERIOD
        if getattr(self, "_self_check_timer", None) is None:
            self._self_check_timer = VirtualTimer(self.clock)

        def fire():
            from .self_check import self_check
            try:
                ok, report = self_check(self, crypto_bench_seconds=0.05,
                                        max_headers=1024)
                if not ok:
                    log.error("automatic self-check FAILED: %s", report)
                else:
                    log.info("automatic self-check ok")
            except Exception:            # noqa: BLE001 — keep rescheduling
                log.exception("automatic self-check crashed")
            if self.state != AppState.APP_STOPPING_STATE:
                self._self_check_timer.expires_from_now(period)
                self._self_check_timer.async_wait(fire)

        self._self_check_timer.expires_from_now(period)
        self._self_check_timer.async_wait(fire)

    def manual_close(self) -> None:
        """reference: Herder::setInSyncAndTriggerNextLedger via the
        `manualclose` admin command (requires MANUAL_CLOSE=true)."""
        if not self.config.MANUAL_CLOSE:
            raise RuntimeError("manualclose requires MANUAL_CLOSE=true")
        self.herder.trigger_next_ledger()
        self.persistent_state.set(
            StateEntry.LAST_CLOSED_LEDGER,
            self.ledger_manager.get_last_closed_ledger_hash().hex())

    def crank(self, block: bool = False) -> int:
        n = self.clock.crank(block)
        n += self.scheduler.run_all()
        return n

    def shutdown(self) -> None:
        self.state = AppState.APP_STOPPING_STATE
        self.telemetry.stop()
        self.controller.stop()
        if self.flight_recorder.active:
            # release the process-wide tracing.ENABLED refcount — a
            # dead app must not keep every other node paying for spans
            self.flight_recorder.stop()
        if getattr(self, "_self_check_timer", None) is not None:
            self._self_check_timer.cancel()
            self._self_check_timer = None
        if self.overlay_manager is not None:
            self.overlay_manager.shutdown()
        self.maintainer.stop()
        self.herder.shutdown()
        if self.batch_verifier is not None and \
                hasattr(self.batch_verifier, "breaker_state"):
            # cancel the breaker's probe timer + release quarantined
            # collect threads: a dead app must not re-probe the device
            self.batch_verifier.shutdown()
        self.work_scheduler.shutdown()
        self.process_manager.shutdown()
        # stop serving reads, then drop the snapshot tier's own pin so
        # shutdown-time GC is not held by a node that no longer serves
        self.query_service.shutdown()
        self.snapshots.shutdown()
        self.bucket_manager.shutdown()
        # drain the deferred close-completion tail before touching the
        # meta stream/debug files or closing the database under it
        self.ledger_manager.join_completion(reraise=False)
        self.ledger_manager.flush_delayed_meta()
        if self._meta_file is not None:
            self._meta_file.close()
        self.ledger_manager._close_debug_meta()
        self.database.close()
        # reset the process-global testing switches THIS app turned on
        # (a later default-config app must not inherit them)
        if self.config.ARTIFICIALLY_REPLAY_WITH_NEWEST_BUCKET_LOGIC_FOR_TESTING:
            from ..bucket.bucket import set_newest_merge_logic
            set_newest_merge_logic(False)
        if self.config.EXPERIMENTAL_BUCKETLIST_DB_PERSIST_INDEX:
            from ..bucket.bucket_index import set_persist_index
            set_persist_index(False)
        if self.config.ARTIFICIALLY_REDUCE_MERGE_COUNTS_FOR_TESTING:
            from ..bucket.bucket_list import set_reduced_merge_counts
            set_reduced_merge_counts(False)
        if self._tmp_bucket_dir is not None:
            self._tmp_bucket_dir.cleanup()
        # reclaim dead-app reference cycles: automatic full
        # collections are off (gcpolicy), so a process that churns
        # apps — the test suite, multi-leg benches — must not carry
        # every dead app's graph to exit. Throttled (every Nth
        # teardown): the deferred window is a few dead app graphs,
        # a full pass per teardown cost the suite minutes
        from ..util import gcpolicy
        gcpolicy.teardown_collect()

    def __enter__(self) -> "Application":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ---------------------------------------------------------- info/status --
    def info(self) -> dict:
        lm = self.ledger_manager
        lcl = lm.get_last_closed_ledger_header()
        from ..xdr import runtime as xdr_runtime
        from ..xdr.schema import identity as xdr_identity
        out = {
            "build": "stellar-core-tpu dev",
            # reference: the .x-file hashes embedded in the binary and
            # cross-checked against the Rust host (Makefile.am:28-32)
            "xdr": xdr_identity(),
            "ledger": {
                "num": lcl.ledgerSeq,
                "hash": lm.get_last_closed_ledger_hash().hex(),
                "version": lcl.ledgerVersion,
                "baseFee": lcl.baseFee,
                "baseReserve": lcl.baseReserve,
                "maxTxSetSize": lcl.maxTxSetSize,
                "closeTime": lcl.scpValue.closeTime,
            },
            "state": _state_name(self.state),
            "network": self.config.NETWORK_PASSPHRASE,
            "protocol_version": self.config.LEDGER_PROTOCOL_VERSION,
            "num_pending_txs": self.herder.tx_queue.size_txs(),
            # whether the native XDR codec serves this process, or the
            # Python path does (SC_XDR_NATIVE=0, or its build or load
            # failed): a harness holds node processes to it
            "xdr_native": xdr_runtime._nc() is not None,
        }
        # actual bound admin port (set by the `run` command — with
        # HTTP_PORT=0 the OS picks it, and a harness polling `info`
        # learns where it actually landed)
        if getattr(self, "http_port", None):
            out["http_port"] = self.http_port
        return out


def _state_name(state: int) -> str:
    names = {
        AppState.APP_CREATED_STATE: "Booting",
        AppState.APP_ACQUIRING_CONSENSUS_STATE: "Joining SCP",
        AppState.APP_CONNECTED_STANDBY_STATE: "Connected",
        AppState.APP_CATCHING_UP_STATE: "Catching up",
        AppState.APP_SYNCED_STATE: "Synced!",
        AppState.APP_STOPPING_STATE: "Stopping",
    }
    return names.get(state, "Unknown")
