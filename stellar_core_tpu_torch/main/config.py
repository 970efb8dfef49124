"""Node configuration.

Reference: src/main/Config.{h,cpp} — a TOML file of ~130 flags parsed in
Config::load (Config.cpp:740-780). We implement the load path with the
stdlib ``tomllib`` and keep the reference's UPPER_SNAKE field names so
operator configs read the same. Node *roles* are derived MODE_* booleans
(Config.h:300-353) that offline commands and tests flip instead of forking
code paths.
"""

from __future__ import annotations

try:
    import tomllib
except ImportError:                                  # pragma: no cover
    # python < 3.11: gate the stdlib TOML parser; config-file loading
    # raises only if actually used without a parser available
    try:
        import tomli as tomllib
    except ImportError:
        tomllib = None
from typing import Dict, List, Optional

from ..crypto.keys import SecretKey
from ..crypto.sha import sha256


class QuorumSetConfig:
    """Declarative quorum set: threshold + validators + inner sets
    (reference: Config.h QUORUM_SET, parsed in Config.cpp)."""

    def __init__(self, threshold: int = 0,
                 validators: Optional[List[bytes]] = None,
                 inner_sets: Optional[List["QuorumSetConfig"]] = None):
        self.threshold = threshold
        self.validators = validators or []
        self.inner_sets = inner_sets or []

    def to_scp_quorum_set(self):
        from ..xdr.scp import SCPQuorumSet
        from ..xdr.types import NodeID, PublicKey
        return SCPQuorumSet(
            threshold=self.threshold,
            validators=[PublicKey.ed25519(v) for v in self.validators],
            innerSets=[s.to_scp_quorum_set() for s in self.inner_sets])


class Config:
    # reference: Config.h field-for-field for the subset we support
    def __init__(self):
        # identity
        self.NETWORK_PASSPHRASE = "Standalone Network ; February 2017"
        self.NODE_SEED: Optional[SecretKey] = None
        self.NODE_IS_VALIDATOR = False
        self.NODE_HOME_DOMAIN = ""

        # modes (reference: RUN_STANDALONE Config.h:137, MANUAL_CLOSE :140)
        self.RUN_STANDALONE = False
        self.MANUAL_CLOSE = False
        # periodic self-check, seconds; 0 disables (reference:
        # AUTOMATIC_SELF_CHECK_PERIOD, ApplicationImpl.cpp:823-826)
        self.AUTOMATIC_SELF_CHECK_PERIOD = 0.0
        self.MODE_DOES_CATCHUP = True   # reference: Config.cpp:116
        # store tx/txfee/txset history tables (reference:
        # MODE_STORES_HISTORY_MISC, Config.h:339 — in-memory replay and
        # catchup utility modes turn this off)
        self.MODE_STORES_HISTORY_MISC = True
        self.FORCE_SCP = False

        # admin HTTP. In the `run` command, 0 binds an OS-assigned
        # ephemeral port (reported on stdout / the `info` route /
        # --port-file, so parallel harness nodes never collide) and a
        # negative value disables the server entirely.
        self.HTTP_PORT = 11626
        self.PUBLIC_HTTP_PORT = False

        # storage
        self.DATABASE = "sqlite3://:memory:"
        self.BUCKET_DIR_PATH: Optional[str] = None  # None = tmp dir

        # ledger
        self.LEDGER_PROTOCOL_VERSION = 21
        self.EXPECTED_LEDGER_CLOSE_TIME = 5.0
        self.MAX_TX_SET_SIZE = 1000  # ops (reference: TESTING default 100)

        # overlay
        self.PEER_PORT = 11625
        self.TARGET_PEER_CONNECTIONS = 8
        self.MAX_PENDING_CONNECTIONS = 500
        self.KNOWN_PEERS: List[str] = []
        self.PREFERRED_PEERS: List[str] = []
        self.MAX_ADVERT_CACHE_SIZE = 50000
        # advert-batch drain cadence (reference: FLOOD_ADVERT_PERIOD_MS,
        # Config.h — pull-mode adverts leave in batches on this timer)
        self.FLOOD_ADVERT_PERIOD_MS = 100
        # unanswered FLOOD_DEMANDs are re-demanded from a different
        # peer after this long (reference: FLOOD_DEMAND_PERIOD_MS +
        # TxDemandsManager retry backoff). 2000, not the reference's
        # 200: a demand here is answered on the advertiser's next
        # crank, and a crank busy with a ledger close parks for
        # seconds — at 200ms the TPSMT leg measured 45% of demands
        # "timing out" (35k spurious retries, ~10k duplicate bodies,
        # exactly the redundancy single-flight exists to kill); the
        # deadline must cover peer CRANK latency under load, not just
        # wire RTT
        self.FLOOD_DEMAND_PERIOD_MS = 2000
        self.PEER_FLOOD_READING_CAPACITY = 200
        self.PEER_READING_CAPACITY = 201
        self.FLOW_CONTROL_SEND_MORE_BATCH_SIZE = 40
        self.PEER_FLOOD_READING_CAPACITY_BYTES = 300000
        self.FLOW_CONTROL_SEND_MORE_BATCH_SIZE_BYTES = 100000

        # consensus
        self.QUORUM_SET = QuorumSetConfig()
        self.UNSAFE_QUORUM = False
        self.QUORUM_INTERSECTION_CHECKER = True

        # herder/tx queue
        self.TRANSACTION_QUEUE_SIZE_MULTIPLIER = 2
        self.TRANSACTION_QUEUE_BAN_DEPTH = 10
        self.TRANSACTION_QUEUE_PENDING_DEPTH = 4

        # history archives: name -> {"get": tmpl, "put": tmpl, "mkdir": tmpl}
        self.HISTORY: Dict[str, Dict[str, str]] = {}
        self.CATCHUP_COMPLETE = False
        self.CATCHUP_RECENT = 0
        # streaming catchup pipeline (catchup/pipeline.py,
        # docs/CATCHUP.md): overlap download → verify → device
        # prevalidate → apply across checkpoints instead of replaying
        # them strictly one at a time; False keeps the sequential
        # CatchupWork reference path
        self.CATCHUP_PIPELINE = True
        # checkpoints the download stage may run ahead of apply
        self.CATCHUP_PIPELINE_AHEAD_CHECKPOINTS = 8
        # byte budget for downloaded-but-unapplied checkpoint files: a
        # fast archive over a slow apply parks the download stage here
        self.CATCHUP_PIPELINE_BYTE_BUDGET = 64 * 1024 * 1024
        # verified checkpoints ahead of apply the device prevalidation
        # stage may fuse into one coalesced signature batch
        self.CATCHUP_PIPELINE_PREVALIDATE_AHEAD = 4

        # upgrades this validator votes for (reference: Upgrades params
        # come via the `upgrades` admin endpoint; the TESTING_UPGRADE_*
        # config fields seed them for tests)
        self.TESTING_UPGRADE_LEDGER_PROTOCOL_VERSION: Optional[int] = None
        self.TESTING_UPGRADE_DESIRED_FEE: Optional[int] = None
        self.TESTING_UPGRADE_RESERVE: Optional[int] = None
        self.TESTING_UPGRADE_MAX_TX_SET_SIZE: Optional[int] = None

        # invariants (reference: INVARIANT_CHECKS, regex list)
        self.INVARIANT_CHECKS: List[str] = []

        # serve entry loads from bucket indexes instead of SQL
        # (reference: EXPERIMENTAL_BUCKETLIST_DB, bucket/readme.md:86-105)
        self.EXPERIMENTAL_BUCKETLIST_DB = False

        # artificial testing knobs (reference: Config.h:168-211)
        self.ARTIFICIALLY_GENERATE_LOAD_FOR_TESTING = False
        self.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING = False
        self.ARTIFICIALLY_SET_CLOSE_TIME_FOR_TESTING = 0
        # force every bucket merge to run synchronously on the calling
        # thread — the pessimal schedule (reference:
        # ARTIFICIALLY_PESSIMIZE_MERGES_FOR_TESTING)
        self.ARTIFICIALLY_PESSIMIZE_MERGES_FOR_TESTING = False
        # honor the `chaos` admin route's install/clear modes
        # (util/chaos.py) — a production node must not accept fault
        # injection over HTTP, so this is off unless a test/staging
        # config opts in
        self.ALLOW_CHAOS_INJECTION = False
        # honor the `recordstart`/`recordstop`/`recorddump` admin
        # routes (replay/recorder.py) — recording captures every
        # inbound frame verbatim, so like chaos it is off unless a
        # test/staging config opts in
        self.ALLOW_INPUT_RECORDING = False
        # microseconds slept by an io-poller on EVERY clock crank —
        # models a slow main thread (reference:
        # ARTIFICIALLY_SLEEP_MAIN_THREAD_FOR_TESTING)
        self.ARTIFICIALLY_SLEEP_MAIN_THREAD_FOR_TESTING_US = 0
        # simulated per-transaction apply latency: durations (ms) drawn
        # by weight, deterministically rotated per applied tx
        # (reference: OP_APPLY_SLEEP_TIME_WEIGHT/_DURATION_FOR_TESTING,
        # ledger/LedgerManagerImpl.cpp:945-969)
        self.OP_APPLY_SLEEP_TIME_WEIGHT_FOR_TESTING: List[int] = []
        self.OP_APPLY_SLEEP_TIME_DURATION_FOR_TESTING: List[float] = []
        # conflict-staged parallel tx apply inside ledger close
        # (ledger/parallel_apply.py; the parallel apply phases of
        # SOSP 2019 §6): worker count, 0 = sequential apply. Results
        # are byte-identical either way — the knob trades close
        # latency against threads.
        self.APPLY_PARALLEL = 4
        # txsets below this size skip staging (setup outweighs overlap)
        self.APPLY_PARALLEL_MIN_TXS = 8

        # retention/maintenance tuning (reference:
        # AUTOMATIC_MAINTENANCE_PERIOD/_COUNT, Config.h)
        self.AUTOMATIC_MAINTENANCE_PERIOD = 3600.0
        self.AUTOMATIC_MAINTENANCE_COUNT = 50000
        # SCP slots kept in memory behind the LCL (reference:
        # MAX_SLOTS_TO_REMEMBER, Herder.h)
        self.MAX_SLOTS_TO_REMEMBER = 12

        # meta stream for downstream systems (reference:
        # METADATA_OUTPUT_STREAM — fd:N or file path; we support paths)
        self.METADATA_OUTPUT_STREAM = ""
        # rotated LedgerCloseMeta debug files under
        # <bucket-dir>/meta-debug, 0 = off (reference:
        # METADATA_DEBUG_LEDGERS, Config.h:422)
        self.METADATA_DEBUG_LEDGERS = 0

        # emit (off-consensus) soroban diagnostic events into V3 meta
        # (reference: ENABLE_SOROBAN_DIAGNOSTIC_EVENTS, Config.h:571)
        self.ENABLE_SOROBAN_DIAGNOSTIC_EVENTS = False

        # ---- tranche 3 ----
        # eviction/archival genesis overrides (reference: Config.h
        # OVERRIDE_EVICTION_PARAMS_FOR_TESTING + TESTING_* fields —
        # applied to the StateArchivalSettings entry at creation)
        self.OVERRIDE_EVICTION_PARAMS_FOR_TESTING = False
        self.TESTING_EVICTION_SCAN_SIZE = 1000
        self.TESTING_MAX_ENTRIES_TO_ARCHIVE = 100
        self.TESTING_MINIMUM_PERSISTENT_ENTRY_LIFETIME = 16
        self.TESTING_STARTING_EVICTION_SCAN_LEVEL = 1

        # tx queue: at most ONE pending tx per source account
        # (reference: LIMIT_TX_QUEUE_SOURCE_ACCOUNT)
        self.LIMIT_TX_QUEUE_SOURCE_ACCOUNT = False

        # rate-limited tx flooding, per lane (reference:
        # FLOOD_TX_PERIOD_MS / FLOOD_OP_RATE_PER_LEDGER and the soroban
        # twins — accepted txs advert in budgeted batches per period;
        # period 0 = advert immediately)
        self.FLOOD_TX_PERIOD_MS = 0
        self.FLOOD_OP_RATE_PER_LEDGER = 2.0
        self.FLOOD_SOROBAN_TX_PERIOD_MS = 0
        self.FLOOD_SOROBAN_RATE_PER_LEDGER = 2.0
        # outbound queue cap for TRANSACTION messages per peer, bytes;
        # oldest dropped first (reference: OUTBOUND_TX_QUEUE_BYTE_LIMIT)
        self.OUTBOUND_TX_QUEUE_BYTE_LIMIT = 1024 * 3200
        # total per-peer outbound queue byte budget across ALL flooded
        # classes: past it, the lowest drop-
        # priority class sheds first (gossip, then tx, SCP last and
        # only to newer SCP) so a slow or partitioned peer can never
        # balloon a healthy node's memory. 0 disables the budget.
        self.OUTBOUND_QUEUE_BYTE_LIMIT = 1024 * 4096

        # ledger/db tuning (reference: ENTRY_CACHE_SIZE,
        # PREFETCH_BATCH_SIZE, MAX_BATCH_WRITE_COUNT/_BYTES)
        self.ENTRY_CACHE_SIZE = 4096
        self.PREFETCH_BATCH_SIZE = 1000
        self.MAX_BATCH_WRITE_COUNT = 1024
        self.MAX_BATCH_WRITE_BYTES = 1024 * 1024
        # abort the process instead of failing the tx on internal apply
        # errors (reference: HALT_ON_INTERNAL_TRANSACTION_ERROR)
        self.HALT_ON_INTERNAL_TRANSACTION_ERROR = False
        # dict-backed ledger root, no per-entry SQL (reference:
        # MODE_USES_IN_MEMORY_LEDGER — in-memory replay/catchup modes)
        self.MODE_USES_IN_MEMORY_LEDGER = False

        # bucket subsystem (reference: DISABLE_BUCKET_GC,
        # DISABLE_XDR_FSYNC, ARTIFICIALLY_REDUCE_MERGE_COUNTS_FOR_TESTING,
        # CATCHUP_WAIT_MERGES_TX_APPLY_FOR_TESTING)
        self.DISABLE_BUCKET_GC = False
        self.DISABLE_XDR_FSYNC = False
        self.ARTIFICIALLY_REDUCE_MERGE_COUNTS_FOR_TESTING = False
        self.CATCHUP_WAIT_MERGES_TX_APPLY_FOR_TESTING = False

        # overlay/http/ops (reference: HTTP_MAX_CLIENT,
        # PREFERRED_PEERS_ONLY, MAX_ADDITIONAL_PEER_CONNECTIONS,
        # ALLOW_LOCALHOST_FOR_TESTING, MODE_AUTO_STARTS_OVERLAY,
        # PUBLISH_TO_ARCHIVE_DELAY, HISTOGRAM_WINDOW_SIZE,
        # LOG_FILE_PATH, LOG_COLOR)
        self.HTTP_MAX_CLIENT = 128
        self.PREFERRED_PEERS_ONLY = False
        # inbound slots on top of the outbound target; None = the
        # reference's "auto" (8x TARGET_PEER_CONNECTIONS, derived at
        # use time so a later TARGET change is honored)
        self.MAX_ADDITIONAL_PEER_CONNECTIONS: Optional[int] = None
        self.ALLOW_LOCALHOST_FOR_TESTING = False
        self.MODE_AUTO_STARTS_OVERLAY = True
        self.PUBLISH_TO_ARCHIVE_DELAY = 0.0
        self.HISTOGRAM_WINDOW_SIZE = 5
        self.LOG_FILE_PATH = ""
        self.LOG_COLOR = False

        # ---- tranche 4 ----
        # subprocess concurrency bound (reference:
        # MAX_CONCURRENT_SUBPROCESSES)
        self.MAX_CONCURRENT_SUBPROCESSES = 16
        # store ledger headers (off in throwaway replay modes;
        # reference: MODE_STORES_HISTORY_LEDGERHEADERS)
        self.MODE_STORES_HISTORY_LEDGERHEADERS = True
        # per-bucket sleep during bucket-apply catchup, seconds
        # (reference: ARTIFICIALLY_DELAY_BUCKET_APPLICATION_FOR_TESTING)
        self.ARTIFICIALLY_DELAY_BUCKET_APPLICATION_FOR_TESTING = 0.0
        # overlay tick stops topping up outbound connections
        # (reference: ARTIFICIALLY_SKIP_CONNECTION_ADJUSTMENT_FOR_TESTING)
        self.ARTIFICIALLY_SKIP_CONNECTION_ADJUSTMENT_FOR_TESTING = False
        # BucketIndex tuning (reference:
        # EXPERIMENTAL_BUCKETLIST_DB_INDEX_CUTOFF (MB) /
        # _INDEX_PAGE_SIZE_EXPONENT)
        self.EXPERIMENTAL_BUCKETLIST_DB_INDEX_CUTOFF = 20
        self.EXPERIMENTAL_BUCKETLIST_DB_INDEX_PAGE_SIZE_EXPONENT = 14
        # overlay protocol window advertised in HELLO (reference:
        # OVERLAY_PROTOCOL_VERSION / OVERLAY_PROTOCOL_MIN_VERSION)
        self.OVERLAY_PROTOCOL_VERSION = 29
        self.OVERLAY_PROTOCOL_MIN_VERSION = 27
        # header-flags upgrade vote (reference: TESTING_UPGRADE_FLAGS)
        self.TESTING_UPGRADE_FLAGS: Optional[int] = None
        # byte-level flow control off = message counts only (reference:
        # ENABLE_FLOW_CONTROL_BYTES). NETWORK-WIDE setting: senders stop
        # honoring byte budgets, so a mixed network drops bytes-off
        # peers as protocol violators — exactly as in the reference
        self.ENABLE_FLOW_CONTROL_BYTES = True
        # version string advertised in HELLO (reference: VERSION_STR)
        self.VERSION_STR = ""            # "" = built-in default
        # genesis takes protocol + soroban settings from this config;
        # off = protocol-0 genesis, upgrades voted in (reference:
        # USE_CONFIG_FOR_GENESIS)
        self.USE_CONFIG_FOR_GENESIS = True
        # report/halt on internal tx errors only from this protocol on
        # (reference: LEDGER_PROTOCOL_MIN_VERSION_INTERNAL_ERROR_REPORT)
        self.LEDGER_PROTOCOL_MIN_VERSION_INTERNAL_ERROR_REPORT = 0
        # genesis soroban settings get loadgen-scale limits (reference:
        # TESTING_SOROBAN_HIGH_LIMIT_OVERRIDE)
        self.TESTING_SOROBAN_HIGH_LIMIT_OVERRIDE = False
        # meta stream runs one ledger behind the LCL (reference:
        # EXPERIMENTAL_PRECAUTION_DELAY_META)
        self.EXPERIMENTAL_PRECAUTION_DELAY_META = False
        # merges always run at the newest bucket protocol (reference:
        # ARTIFICIALLY_REPLAY_WITH_NEWEST_BUCKET_LOGIC_FOR_TESTING)
        self.ARTIFICIALLY_REPLAY_WITH_NEWEST_BUCKET_LOGIC_FOR_TESTING = \
            False
        # extra wait before each unanswered-demand retry, ms (reference:
        # FLOOD_DEMAND_BACKOFF_DELAY_MS)
        self.FLOOD_DEMAND_BACKOFF_DELAY_MS = 500
        # persist bucket indexes beside the bucket files (reference:
        # EXPERIMENTAL_BUCKETLIST_DB_PERSIST_INDEX)
        self.EXPERIMENTAL_BUCKETLIST_DB_PERSIST_INDEX = False
        # cross-check every indexed best-offer lookup against a full
        # scan (reference: BEST_OFFER_DEBUGGING_ENABLED)
        self.BEST_OFFER_DEBUGGING_ENABLED = False

        # crypto backend (our addition, SURVEY.md §5.6)
        self.SIGNATURE_VERIFY_BACKEND = "native"  # native|python|cuda|tpu
        # (cuda and tpu both select the CUDA device backend)
        # device topology for the device backend: auto = sharded mesh
        # whenever more than one device is visible, single chip otherwise
        # (SURVEY.md §2.3/§5.8; ops/verifier.py, ops/multihost.py)
        self.SIGNATURE_VERIFY_MESH = "auto"  # auto|single|sharded|hybrid
        # coalescing verify service (ops/verify_service.py; engaged with
        # the device backend): live-path signature verifies queue until the
        # batch reaches VERIFY_MAX_BATCH tuples or the oldest waits
        # VERIFY_BATCH_DEADLINE_MS, then dispatch as one device batch
        self.VERIFY_BATCH_DEADLINE_MS = 2.0
        self.VERIFY_MAX_BATCH = 256
        # flushes below this many signatures run native per-signature —
        # the fixed device dispatch cost loses to the host verifier
        # there (bench.py --min-batch records the measured crossover;
        # VERIFY_DEVICE_MIN_BATCH=<n> in the environment overrides)
        self.VERIFY_DEVICE_MIN_BATCH = 16

        # device-backend supervisor (ops/backend_supervisor.py): the
        # PER-DEVICE circuit-breaker array + hung-dispatch watchdog
        # wrapped around the device backend (docs/ROBUSTNESS.md). The
        # knobs apply to each device's breaker: a sick chip trips
        # alone and the verify mesh shrinks around it; native
        # fallback engages only when every device is down. Trip a
        # device OPEN after this many consecutive dispatch failures
        # attributed to it (fatal errors trip immediately)
        self.VERIFY_BREAKER_FAILURE_THRESHOLD = 3
        # a device collect handle that hasn't produced results after
        # this long is quarantined; the flush resolves through native
        # verify and the breaker records a timeout-class failure
        self.VERIFY_DISPATCH_DEADLINE_MS = 2000.0
        # HALF_OPEN canary re-probe backoff: base doubles per failed
        # probe up to max, with deterministic per-node jitter
        self.VERIFY_BREAKER_PROBE_BASE_MS = 1000.0
        self.VERIFY_BREAKER_PROBE_MAX_MS = 30000.0
        # canary batch size: at least VERIFY_DEVICE_MIN_BATCH or the
        # probe exercises only the host bypass, not the device
        self.VERIFY_BREAKER_CANARY_BATCH = 16

        # telemetry time-series (util/timeseries.py): a bounded ring
        # of periodic health snapshots (close/tx-e2e/slot quantiles,
        # verify occupancy + queue depth, breaker state, flood
        # duplicate ratio, dispatch batch/padding, host loadavg),
        # sampled every TELEMETRY_SAMPLE_PERIOD seconds on the app
        # clock (VirtualClock in sims, wall clock in `run`). 0 leaves
        # the recurring timer unarmed — sample_now() still works, the
        # opt-in tests and manual-close benches use. Scraped over the
        # `timeseries` route with the since=<cursor> contract.
        self.TELEMETRY_SAMPLE_PERIOD = 1.0
        self.TELEMETRY_RING_CAPACITY = 600
        # SLO watchdog (ops/slo.py) thresholds, evaluated per sample:
        # close p99 / tx-e2e p99 ceilings (ms), how long the device
        # breaker may sit OPEN before degraded mode counts as a breach
        # (s), and the flood-redundancy ceiling (duplicate deliveries
        # per unique message). Verdicts ride slo.* counters, trace
        # instants, and the `slo` admin route.
        self.SLO_CLOSE_P99_MS = 5000.0
        self.SLO_TX_E2E_P99_MS = 15000.0
        self.SLO_BREAKER_OPEN_DWELL_S = 10.0
        self.SLO_DUPLICATE_RATIO_MAX = 8.0
        # read-tier ceiling: query.read.latency p99 (ms) — the read
        # path degrades (sheds) before the write path ever does
        self.SLO_READ_P99_MS = 100.0

        # read-serving tier (query/): worker pool size, bounded
        # admission queue depth, per-request deadline, and the floor on
        # the hedged-second-lookup trigger (the hedge normally fires at
        # the rolling p95 read latency; the floor stops hedge storms
        # while the estimate is still cold). Tx-status ring: capacity in
        # transactions and the TTL (s) against ledger close time.
        self.QUERY_WORKER_THREADS = 4
        self.QUERY_QUEUE_LIMIT = 512
        self.QUERY_DEADLINE_MS = 250.0
        self.QUERY_HEDGE_MIN_MS = 5.0
        self.QUERY_TX_STATUS_CAPACITY = 65536
        self.QUERY_TX_STATUS_TTL = 600.0

        # adaptive control plane (ops/controller.py): a recurring
        # tick on the app clock reads the newest telemetry sample and
        # (a) AIMD-searches the three VERIFY_* batch knobs above from
        # measured occupancy + queue-wait p99, (b) ramps tx-submit /
        # flood-admission shed probabilities from the SLO watchdog's
        # WARN/BREACH verdicts plus a learned-backlog surge gate.
        # 0 leaves the timer unarmed — tick() still works, which is
        # how the surge bench and virtual-time tests drive
        # deterministic control steps (the TELEMETRY_SAMPLE_PERIOD
        # discipline). Frozen/reset over the `controller` admin route.
        self.CONTROLLER_TICK_PERIOD = 1.0
        # AIMD step sizes: additive max-batch probe / multiplicative
        # deadline+batch back-off / deadline stretch toward device
        # profitability (Clipper's adaptive batch search, PAPERS.md)
        self.CONTROLLER_AIMD_INCREASE = 16
        self.CONTROLLER_AIMD_DECREASE = 0.5
        self.CONTROLLER_DEADLINE_GROW = 1.25
        # the latency objective the batch search holds: verify-service
        # submit→dispatch wait p99 (ms)
        self.CONTROLLER_QUEUE_WAIT_TARGET_MS = 5.0
        # shed ladder: WARN ramps tx-submit by SHED_STEP, BREACH ramps
        # tx by 2x and flood by 1x; OK decays both by SHED_DECAY; both
        # probabilities cap at SHED_MAX (never a full blackout — some
        # load must keep flowing so recovery is observable)
        self.CONTROLLER_SHED_STEP = 0.2
        self.CONTROLLER_SHED_DECAY = 0.1
        self.CONTROLLER_SHED_MAX = 0.95
        # surge gate: slam the tx-submit shed to SHED_MAX when the
        # pending queue exceeds what would close inside
        # SLO_CLOSE_P99_MS x this factor at the learned per-tx cost
        self.CONTROLLER_BACKLOG_FACTOR = 0.4

        # drop a peer once this many of its transactions failed
        # signature verification (overlay/manager.py): a bad-sig
        # flooder burns device verify batches on work that can never
        # apply — past the threshold it goes through the standard drop
        # path and stops monopolizing batch admission. 0 disables.
        # Counted on the batched-admission path (the verify service
        # path a flooder actually attacks).
        self.PEER_BAD_SIG_DROP_THRESHOLD = 100

        # overlay socket deadlines (overlay/tcp_peer.py): a black-holed
        # peer must not pin a connection slot forever. Transport must
        # carry a first byte within PEER_CONNECT_TIMEOUT of dialing;
        # the handshake must reach GOT_AUTH within
        # PEER_AUTHENTICATION_TIMEOUT of transport establishment
        # (reference: PEER_AUTHENTICATION_TIMEOUT, Config.h); an
        # authenticated peer silent for PEER_TIMEOUT is dropped
        # (reference: PEER_TIMEOUT). Seconds; 0 disables that check.
        self.PEER_CONNECT_TIMEOUT = 5.0
        self.PEER_AUTHENTICATION_TIMEOUT = 2.0
        self.PEER_TIMEOUT = 30.0

        # how long a failed/ineffective catchup (target, lcl) attempt
        # suppresses an identical retry (catchup/manager.py) — long
        # enough for the archive to publish a new checkpoint. Each
        # node jitters its own window (+0..25%, seeded by node id) so
        # simultaneously out-of-sync nodes don't hammer the archive in
        # lockstep (Tail-at-Scale retry decorrelation, PAPERS.md)
        self.RETRY_SUPPRESSION_SECONDS = 300.0

        # worker threads
        self.WORKER_THREADS = 4

        # lazily drawn per-process seed for watcher nodes (no
        # NODE_SEED) — see jitter_seed()
        self._fallback_jitter_seed = None

    # ------------------------------------------------------------- derived --
    def network_id(self) -> bytes:
        """networkID = SHA256(passphrase) (reference:
        main/ApplicationImpl.cpp networkID())."""
        return sha256(self.NETWORK_PASSPHRASE.encode())

    def node_id(self) -> bytes:
        assert self.NODE_SEED is not None
        return self.NODE_SEED.public_key().raw

    def jitter_seed(self) -> int:
        """Per-node seed for decorrelation jitter (breaker probe
        backoff, catchup retry suppression): stable for one node — the
        chaos repro contract — and decorrelated across nodes. Watcher
        nodes (no NODE_SEED) get a per-process random seed drawn once:
        a constant fallback would make every watcher jitter in
        lockstep, defeating the retry decorrelation entirely."""
        if self.NODE_SEED is None:
            if self._fallback_jitter_seed is None:
                import os
                self._fallback_jitter_seed = int.from_bytes(
                    os.urandom(8), "little")
            return self._fallback_jitter_seed
        return int.from_bytes(self.node_id()[:8], "little")

    def mode_stores_history(self) -> bool:
        return bool(self.HISTORY)

    # Node-role booleans (reference: Config MODE_* flags,
    # main/Config.h:300-353 — offline commands and tests flip these
    # instead of forking code paths). Only roles with real behavior in
    # this build are modeled: the bucket list is always on, and
    # in-memory mode is is_in_memory_mode().
    def mode_does_catchup(self) -> bool:
        # reference default: true everywhere; offline commands flip the
        # attribute off (Config.cpp:116, CommandLine.cpp:1001)
        return self.MODE_DOES_CATCHUP

    def max_inbound_peer_connections(self) -> int:
        """reference: MAX_ADDITIONAL_PEER_CONNECTIONS "auto" derives
        from the outbound target."""
        if self.MAX_ADDITIONAL_PEER_CONNECTIONS is not None:
            return self.MAX_ADDITIONAL_PEER_CONNECTIONS
        return 8 * self.TARGET_PEER_CONNECTIONS

    def mode_auto_starts_overlay(self) -> bool:
        # reference: MODE_AUTO_STARTS_OVERLAY (off in offline/utility
        # modes even when not standalone)
        return self.MODE_AUTO_STARTS_OVERLAY and not self.RUN_STANDALONE

    def is_in_memory_mode(self) -> bool:
        return self.DATABASE == "sqlite3://:memory:"

    def database_path(self) -> str:
        if self.DATABASE.startswith("sqlite3://"):
            return self.DATABASE[len("sqlite3://"):]
        raise ValueError(f"unsupported DATABASE: {self.DATABASE}")

    # -------------------------------------------------------------- loading --
    @classmethod
    def load(cls, path: str) -> "Config":
        if tomllib is None:
            raise RuntimeError(
                "no TOML parser available (python>=3.11 or the tomli "
                "package is required to load config files)")
        with open(path, "rb") as f:
            doc = tomllib.load(f)
        return cls.from_dict(doc)

    @classmethod
    def from_dict(cls, doc: dict) -> "Config":
        cfg = cls()
        for key, val in doc.items():
            if key == "NODE_SEED":
                cfg.NODE_SEED = _parse_node_seed(val)
            elif key == "QUORUM_SET":
                cfg.QUORUM_SET = _parse_quorum_set(val)
            elif key == "HISTORY":
                cfg.HISTORY = {name: dict(cmds) for name, cmds in val.items()}
            elif hasattr(cfg, key):
                setattr(cfg, key, val)
            else:
                raise ValueError(f"unknown config key: {key}")
        if cfg.NODE_IS_VALIDATOR and cfg.NODE_SEED is None:
            raise ValueError("NODE_IS_VALIDATOR requires NODE_SEED")
        return cfg


def _parse_node_seed(val: str) -> SecretKey:
    from ..crypto.strkey import StrKey
    # "SXXX... self" form from the reference example configs
    seed = val.split()[0]
    return SecretKey.from_seed(StrKey.decode_ed25519_seed(seed))


def _parse_quorum_set(doc: dict) -> QuorumSetConfig:
    from ..crypto.strkey import StrKey
    validators = [StrKey.decode_ed25519_public(v.split()[0])
                  for v in doc.get("VALIDATORS", [])]
    inner = [_parse_quorum_set(s) for s in doc.get("INNER_SETS", [])]
    threshold = doc.get("THRESHOLD",
                        doc.get("THRESHOLD_PERCENT", 0))
    if "THRESHOLD_PERCENT" in doc and "THRESHOLD" not in doc:
        n = len(validators) + len(inner)
        threshold = max(1, (doc["THRESHOLD_PERCENT"] * n + 99) // 100)
    return QuorumSetConfig(threshold, validators, inner)


_test_instance_counter = [0]


def get_test_config(instance: Optional[int] = None,
                    in_memory: bool = True) -> Config:
    """Per-instance test config (reference: test/test.h getTestConfig):
    distinct ports, deterministic per-instance node seed, in-memory
    sqlite, manual close standalone mode."""
    if instance is None:
        instance = _test_instance_counter[0]
        _test_instance_counter[0] += 1
    cfg = Config()
    cfg.RUN_STANDALONE = True
    cfg.MANUAL_CLOSE = True
    cfg.NODE_IS_VALIDATOR = True
    cfg.FORCE_SCP = True
    # tests never call the `run` command, which is the only place the
    # HTTP server starts (0 there now means "bind an ephemeral port" —
    # the cluster harness semantics; a negative value disables)
    cfg.HTTP_PORT = 0
    cfg.ALLOW_CHAOS_INJECTION = True
    cfg.ALLOW_INPUT_RECORDING = True
    # virtual-time tests step timer-to-timer; the hourly maintenance
    # timer would let idle cranks leap an hour, so tests opt in
    cfg.AUTOMATIC_MAINTENANCE_PERIOD = 0.0
    # same discipline for the telemetry sampler: a recurring 1 s timer
    # on every test app's clock heap would keep idle crank_until loops
    # stepping to their timeout instead of exiting on an empty heap —
    # tests (and the manual-close benches) drive sample_now() or opt
    # in per scenario; `run`-mode nodes keep the production default
    cfg.TELEMETRY_SAMPLE_PERIOD = 0.0
    # the adaptive controller's recurring tick too: tests drive
    # controller.tick() manually where a scenario wants the loop
    cfg.CONTROLLER_TICK_PERIOD = 0.0
    cfg.PEER_PORT = 32000 + 2 * instance
    cfg.NETWORK_PASSPHRASE = "(V) (;,,;) (V)"  # reference test passphrase
    cfg.NODE_SEED = SecretKey.from_seed(
        sha256(b"test-node-seed-%d" % instance))
    cfg.QUORUM_SET = QuorumSetConfig(
        threshold=1, validators=[cfg.node_id()])
    cfg.UNSAFE_QUORUM = True
    cfg.MAX_TX_SET_SIZE = 100
    cfg.INVARIANT_CHECKS = [".*"]
    # tests dial 127.0.0.1 freely (reference: getTestConfig sets this)
    cfg.ALLOW_LOCALHOST_FOR_TESTING = True
    # reference: getTestConfig disables XDR fsync (production keeps it)
    cfg.DISABLE_XDR_FSYNC = True
    return cfg
