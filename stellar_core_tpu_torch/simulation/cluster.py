"""Multi-process cluster harness: real node processes, real TCP.

ROADMAP item 4's designated gap: every scale/chaos scenario before this
ran nodes in-process, where one GIL and the shared ``_verify_cache``
distort wall-clock numbers (both have bitten before). This harness gives
each node what production gives it — its own process, its own sqlite
file + bucket ``data_dir``, its own ports — and drives everything
through the admin HTTP API a real operator would use:

- **config rendering** — one TOML file per node (unique overlay/HTTP
  ports, quorum sets from ``simulation/topologies.tiered_qset``,
  ``ALLOW_CHAOS_INJECTION`` only here, never in production configs),
  then ``new-db`` and a real ``python -m stellar_core_tpu_torch run``
  subprocess per node with ``HTTP_PORT=0`` + ``--port-file`` so
  parallel clusters never collide on ports;
- **mesh wiring** — the same tiered link list the in-process builder
  uses (``topologies.tiered_links``), carried by ``KNOWN_PEERS`` dial
  retry plus harness-driven ``connect`` nudges over the admin API;
- **load** — ``generateload`` create/pay rounds against one node, the
  flood crossing real authenticated TCP sockets;
- **chaos** — seeded per-process fault schedules installed over the
  ``chaos`` route; **churn is a real ``kill -9``** (SIGKILL, not a
  simulated crash), restart from the persisted ``data_dir``, catchup
  over the wire (peers answer GET_SCP_STATE within
  MAX_SLOTS_TO_REMEMBER);
- **verdicts** — collected from ``clusterstatus``/``peers``/``metrics``
  with deadline-bounded polls and per-node seeded, decorrelated retry
  jitter (Dean & Barroso, *Tail at Scale*, CACM 2013: never a blocking
  wait on one slow node; the ``config.jitter_seed()`` derivation keeps
  N freshly spawned pollers from hammering a still-booting peer in
  lockstep). Safety is ``simulation/byzantine.header_chains_agree`` —
  byte-identical honest-survivor header chains — over
  ``clusterstatus?headers=A-B`` exports;
- **tracing** — per-node ``starttrace``/``dumptrace`` exports stitched
  into ONE cluster-wide Chrome trace by
  ``util/tracemerge.merge_trace_docs`` (wall-clock-anchored lanes).

Consumers: ``bench.py --tps-cluster`` (the CLUSTER artifact: the first
wall-clock-faithful multinode numbers beside the in-process TPSM/TPSMT
ones), ``tests/test_cluster_harness.py`` (tier-1 3-process smoke, slow
9-node chaos leg).
"""

from __future__ import annotations

import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional

from ..crypto.strkey import StrKey
from ..util.logging import get_logger
from . import topologies
from .byzantine import header_chains_agree

log = get_logger("Chaos")

# one HTTP request never waits longer than this; slow nodes are retried
# (with per-node jitter) until the caller's DEADLINE, not blocked on
REQUEST_TIMEOUT_S = 3.0
POLL_BASE_S = 0.1
# retry jitter fraction: sleep = base * (1 + U[0, JITTER_FRAC)) drawn
# from the node's own seeded RNG — decorrelated across nodes, stable
# per node (the config.jitter_seed() pattern)
JITTER_FRAC = 1.0

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class ClusterError(RuntimeError):
    pass


# ------------------------------------------------------------ rendering --
def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, str):
        return json.dumps(v)          # TOML basic string, ASCII-safe
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"unrenderable TOML value: {v!r}")


def _render_quorum_set(qset, path: str = "QUORUM_SET",
                       _as_array: bool = False) -> List[str]:
    """TOML table (+ nested array-of-tables) in exactly the shape
    Config._parse_quorum_set reads back."""
    lines = [("[[%s]]" if _as_array else "[%s]") % path,
             f"THRESHOLD = {qset.threshold}",
             "VALIDATORS = [" + ", ".join(
                 json.dumps(StrKey.encode_ed25519_public(v))
                 for v in qset.validators) + "]"]
    for inner in qset.inner_sets:
        lines.append("")
        lines.extend(_render_quorum_set(inner, path + ".INNER_SETS",
                                        _as_array=True))
    return lines


# ----------------------------------------------------------------- nodes --
class ClusterNode:
    """One spawned node: rendered config, subprocess handle, admin-API
    client with deadline-bounded, jitter-decorrelated polling."""

    def __init__(self, name: str, seed, peer_port: int, data_dir: str):
        self.name = name
        self.seed = seed
        self.node_id: bytes = seed.public_key().raw
        self.peer_port = peer_port
        self.data_dir = data_dir
        self.cfg_path = os.path.join(data_dir, "node.cfg")
        self.port_file = os.path.join(data_dir, "http.port")
        self.log_path = os.path.join(data_dir, "node.log")
        self.proc: Optional[subprocess.Popen] = None
        self._log_file = None
        self.http_port: Optional[int] = None
        self.known_peers: List[str] = []
        self.neighbors: List["ClusterNode"] = []
        self.is_validator = True
        # incremental telemetry scrape state (the `timeseries` route's
        # since=<cursor> contract): the last cursor token this harness
        # saw, and every sample collected so far. A restart rotates
        # the node's epoch, so the next scrape self-heals with
        # reset=true — no harness-side restart bookkeeping needed.
        self.ts_token: Optional[str] = None
        self.ts_samples: List[dict] = []
        self.ts_resets = 0
        # the config.jitter_seed() derivation, computed harness-side:
        # stable for this node, decorrelated from every other node's
        # poller — N spawned processes never retry in lockstep
        self._rng = random.Random(
            int.from_bytes(self.node_id[:8], "little"))

    # ------------------------------------------------------------- state --
    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def jittered_sleep(self, base: float = POLL_BASE_S) -> None:
        time.sleep(base * (1.0 + self._rng.random() * JITTER_FRAC))

    # -------------------------------------------------------------- http --
    def get(self, command: str, params: Optional[dict] = None,
            timeout: float = REQUEST_TIMEOUT_S) -> dict:
        """One admin-API request. Raises OSError/ValueError on
        transport/parse failure, ClusterError on an app-level
        ``{"exception": ...}`` reply."""
        if self.http_port is None:
            raise ClusterError(f"{self.name}: no HTTP port yet")
        url = f"http://127.0.0.1:{self.http_port}/{command}"
        if params:
            url += "?" + urllib.parse.urlencode(params)
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            doc = json.loads(resp.read().decode())
        if isinstance(doc, dict) and "exception" in doc:
            raise ClusterError(f"{self.name}: {command}: "
                               f"{doc['exception']}")
        return doc

    def poll(self, command: str, params: Optional[dict] = None,
             deadline: float = 0.0,
             ok: Optional[Callable[[dict], bool]] = None
             ) -> Optional[dict]:
        """Deadline-bounded poll: retry (jittered) until `ok(doc)` or
        the monotonic `deadline`; returns None on expiry — the caller
        decides whether a slow node fails a verdict, the poll itself
        never blocks past the deadline."""
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                doc = self.get(command, params,
                               timeout=min(REQUEST_TIMEOUT_S,
                                           max(0.1, remaining)))
                if ok is None or ok(doc):
                    return doc
            except (OSError, ValueError, ClusterError):
                pass
            self.jittered_sleep()


# --------------------------------------------------------------- cluster --
class Cluster:
    """A tiered quorum of real node processes on localhost TCP.

    ``Cluster(3, 3, root_dir)`` renders nine configs, initializes nine
    databases, spawns nine ``run`` subprocesses on ephemeral admin
    ports, and wires the tiered mesh. Lifecycle: ``start_all`` →
    (drive) → ``stop_all(graceful=True)`` / ``close()``.
    """

    def __init__(self, n_orgs: int, validators_per_org: int,
                 root_dir: str, passphrase: str = "cluster harness net",
                 close_time: float = 0.5, max_tx_set_size: int = 2000,
                 bad_sig_threshold: int = 16,
                 max_slots_to_remember: int = 64,
                 log_level: str = "warning",
                 extra_config: Optional[dict] = None):
        self.root_dir = root_dir
        self.passphrase = passphrase
        self.close_time = close_time
        self.max_tx_set_size = max_tx_set_size
        self.bad_sig_threshold = bad_sig_threshold
        self.max_slots_to_remember = max_slots_to_remember
        self.log_level = log_level
        self.extra_config = dict(extra_config or {})

        org_seeds = topologies.tiered_org_seeds(n_orgs,
                                                validators_per_org)
        org_ids = [[s.public_key().raw for s in org]
                   for org in org_seeds]
        self.qset = topologies.tiered_qset(org_ids)
        flat_seeds = [s for org in org_seeds for s in org]
        ports = _free_ports(len(flat_seeds))
        self.nodes: List[ClusterNode] = []
        for i, s in enumerate(flat_seeds):
            name = "node%02d" % i
            data_dir = os.path.join(root_dir, name)
            os.makedirs(data_dir, exist_ok=True)
            self.nodes.append(ClusterNode(name, s, ports[i], data_dir))
        self._by_id: Dict[bytes, ClusterNode] = {
            n.node_id: n for n in self.nodes}
        self.links = topologies.tiered_links(org_ids)
        index = {n.node_id: i for i, n in enumerate(self.nodes)}
        for a, b, _kind in self.links:
            na, nb = self._by_id[a], self._by_id[b]
            na.neighbors.append(nb)
            nb.neighbors.append(na)
            # the later node dials the earlier (the TCP-bench pattern);
            # the harness's connect nudges cover any link that fails to
            # come up from dial retry alone
            dialer, listener = (na, nb) if index[a] > index[b] \
                else (nb, na)
            dialer.known_peers.append(
                f"127.0.0.1:{listener.peer_port}")
        for node in self.nodes:
            self._render_config(node)

    # --------------------------------------------------------- rendering --
    def _render_config(self, node: ClusterNode) -> None:
        doc = {
            "NETWORK_PASSPHRASE": self.passphrase,
            "NODE_SEED": StrKey.encode_ed25519_seed(node.seed.seed)
            + " self",
            "NODE_IS_VALIDATOR": node.is_validator,
            "FORCE_SCP": True,
            "RUN_STANDALONE": False,
            "MANUAL_CLOSE": False,
            "EXPECTED_LEDGER_CLOSE_TIME": float(self.close_time),
            # ephemeral admin port (satellite: parallel harness nodes
            # never collide); the run command reports the bound port
            # via --port-file
            "HTTP_PORT": 0,
            "PEER_PORT": node.peer_port,
            "KNOWN_PEERS": list(node.known_peers),
            "DATABASE": "sqlite3://" + os.path.join(node.data_dir,
                                                    "node.db"),
            "BUCKET_DIR_PATH": os.path.join(node.data_dir, "buckets"),
            "ALLOW_LOCALHOST_FOR_TESTING": True,
            # ONLY in rendered harness configs — the chaos route's
            # install/clear modes stay refused on production nodes
            "ALLOW_CHAOS_INJECTION": True,
            # input recording armed on every harness node: a failed matrix cell ships each node's
            # per-process replay log alongside its data_dir
            "ALLOW_INPUT_RECORDING": True,
            "MAX_TX_SET_SIZE": self.max_tx_set_size,
            "TESTING_UPGRADE_MAX_TX_SET_SIZE": self.max_tx_set_size,
            # generous overlay catchup window: a kill -9'd node must be
            # able to rejoin over GET_SCP_STATE even when its restart
            # (a full process boot) costs several slots
            "MAX_SLOTS_TO_REMEMBER": self.max_slots_to_remember,
            "PEER_BAD_SIG_DROP_THRESHOLD": self.bad_sig_threshold,
            # hourly timers have no place in a minutes-long scenario
            "AUTOMATIC_MAINTENANCE_PERIOD": 0.0,
        }
        doc.update(self.extra_config)
        lines = [f"{k} = {_toml_value(v)}" for k, v in doc.items()]
        lines.append("")
        lines.extend(_render_quorum_set(self.qset))
        lines.append("")
        with open(node.cfg_path, "w") as f:
            f.write("\n".join(lines))

    # --------------------------------------------------------- lifecycle --
    def _cli(self, node: ClusterNode, *args: str) -> List[str]:
        return [sys.executable, "-m", "stellar_core_tpu_torch",
                "--conf", node.cfg_path, "--ll", self.log_level,
                *args]

    def new_db(self, node: ClusterNode) -> None:
        res = subprocess.run(self._cli(node, "new-db"),
                             cwd=_REPO_ROOT, capture_output=True,
                             text=True, timeout=120)
        if res.returncode != 0:
            raise ClusterError(f"{node.name}: new-db failed: "
                               f"{res.stderr[-500:]}")

    def spawn(self, node: ClusterNode) -> None:
        """Start (or restart) the node's ``run`` subprocess. The stale
        port file is removed first: an ephemeral port changes across
        restarts, and reading last boot's port would poll a ghost."""
        if node.alive:
            raise ClusterError(f"{node.name} is already running")
        if os.path.exists(node.port_file):
            os.unlink(node.port_file)
        node.http_port = None
        if node._log_file is not None:
            # kill -9 leaves the previous handle open; a churn loop
            # must not leak one fd per restart cycle
            node._log_file.close()
        node._log_file = open(node.log_path, "ab")
        node.proc = subprocess.Popen(
            self._cli(node, "run", "--port-file", node.port_file),
            cwd=_REPO_ROOT, stdout=node._log_file,
            stderr=subprocess.STDOUT,
            start_new_session=True)
        log.info("%s: spawned pid %d (peer port %d)", node.name,
                 node.proc.pid, node.peer_port)

    def start_all(self, deadline_s: float = 120.0) -> None:
        """new-db + spawn every node, then wait (deadline-bounded) for
        every admin API to come up."""
        for node in self.nodes:
            self.new_db(node)
        for node in self.nodes:
            self.spawn(node)
        self.wait_ready(deadline_s)

    def _await_all(self, nodes: List[ClusterNode], deadline_s: float,
                   step: Callable[[ClusterNode], bool],
                   sleep_base: float = POLL_BASE_S
                   ) -> List[ClusterNode]:
        """THE shared waiter discipline (Tail at Scale): each pass
        gives every pending node one short `step`; a node leaves the
        pending set when its step returns True. A wedged node can only
        burn its own verdict — never the budget of nodes stepped after
        it. Returns the stragglers still pending at the deadline
        (empty = success)."""
        deadline = time.monotonic() + deadline_s
        pending = list(nodes)
        while pending and time.monotonic() < deadline:
            pending = [n for n in pending if not step(n)]
            if pending:
                pending[0].jittered_sleep(sleep_base)
        return pending

    def wait_ready(self, deadline_s: float,
                   nodes: Optional[List[ClusterNode]] = None) -> None:
        """Wait until each booting node has written its port file and
        answers ``info``; a node process dying during boot fails fast
        with its log path."""
        def step(node: ClusterNode) -> bool:
            if not node.alive:
                raise ClusterError(
                    f"{node.name} died during boot "
                    f"(rc={node.proc.returncode}); see {node.log_path}")
            if node.http_port is None:
                if not os.path.exists(node.port_file):
                    return False
                with open(node.port_file) as f:
                    node.http_port = int(f.read().strip())
            try:
                doc = node.get("info", timeout=1.0)
                return doc.get("info", {}).get("ledger", {}) \
                    .get("num", 0) >= 1
            except (OSError, ValueError, ClusterError):
                return False

        stragglers = self._await_all(
            list(nodes if nodes is not None else self.nodes),
            deadline_s, step)
        if stragglers:
            raise ClusterError(
                "nodes never became ready: "
                + ", ".join(n.name for n in stragglers))

    def stop_all(self, graceful: bool = True,
                 timeout_s: float = 30.0) -> Dict[str, Optional[int]]:
        """SIGTERM every live node (the graceful-drain satellite) and
        wait; stragglers past the timeout get SIGKILL. Returns each
        node's exit code (None = had to be killed / never ran)."""
        rcs: Dict[str, Optional[int]] = {}
        live = [n for n in self.nodes if n.alive]
        for node in live:
            node.proc.send_signal(
                signal.SIGTERM if graceful else signal.SIGKILL)
        deadline = time.monotonic() + timeout_s
        for node in live:
            try:
                node.proc.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                node.proc.kill()
                node.proc.wait(10)
        for node in self.nodes:
            rcs[node.name] = node.proc.returncode \
                if node.proc is not None else None
            if node._log_file is not None:
                node._log_file.close()
                node._log_file = None
        return rcs

    def close(self) -> None:
        if any(n.alive for n in self.nodes):
            self.stop_all(graceful=False, timeout_s=10.0)
        for node in self.nodes:
            if node._log_file is not None:
                node._log_file.close()
                node._log_file = None

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- churn --
    def kill_node(self, node: ClusterNode) -> None:
        """A REAL kill -9: no drain, no goodbye — everything past the
        last durable commit is lost, exactly what the recovery-marker
        machinery must absorb on restart."""
        if not node.alive:
            raise ClusterError(f"{node.name} is not running")
        log.info("%s: kill -9 pid %d", node.name, node.proc.pid)
        node.proc.kill()
        node.proc.wait(30)

    def restart_node(self, node: ClusterNode,
                     deadline_s: float = 60.0) -> None:
        """Respawn from the persisted data_dir (``run`` without
        --new-db restores LCL + buckets), wait for the admin API, and
        nudge the node's topology links back up via ``connect`` — its
        own dials plus every neighbor's KNOWN_PEERS retry re-knit the
        mesh."""
        self.spawn(node)
        self.wait_ready(deadline_s, nodes=[node])
        for peer in node.neighbors:
            try:
                node.get("connect", {"peer": "127.0.0.1",
                                     "port": str(peer.peer_port)})
            except (OSError, ValueError, ClusterError):
                pass                     # dial retry keeps trying

    # --------------------------------------------------------------- mesh --
    def expected_degree(self, node: ClusterNode) -> int:
        return len(node.neighbors)

    def wait_mesh(self, deadline_s: float = 60.0) -> None:
        """Wait until every node has authenticated its full topology
        degree. KNOWN_PEERS dial retry does most of the work; links
        still missing at each pass get an explicit ``connect`` nudge
        (jitter-decorrelated per node, so a restarted or slow listener
        isn't hammered in lockstep)."""
        def step(node: ClusterNode) -> bool:
            try:
                doc = node.get("clusterstatus", timeout=1.0)
                have = doc["clusterstatus"]["peers"]["authenticated"]
            except (OSError, ValueError, ClusterError, KeyError):
                return False
            if have >= self.expected_degree(node):
                return True
            for peer in node.neighbors:
                try:
                    node.get("connect", {"peer": "127.0.0.1",
                                         "port": str(peer.peer_port)})
                except (OSError, ValueError, ClusterError):
                    pass
            return False

        stragglers = self._await_all(self.nodes, deadline_s, step,
                                     sleep_base=POLL_BASE_S * 2)
        if stragglers:
            raise ClusterError(
                "mesh never fully authenticated: "
                + ", ".join(n.name for n in stragglers))

    # ----------------------------------------------------------- consensus --
    def lcl(self, node: ClusterNode, deadline_s: float = 15.0) -> int:
        """Current LCL, retried (jittered) within a deadline: admin
        requests queue behind the node's crank loop, so a node busy
        applying a big txset can miss one 3s request without meaning
        anything — the same discipline as every other poll here."""
        doc = node.poll("info", deadline=time.monotonic() + deadline_s,
                        ok=lambda d: "info" in d)
        if doc is None:
            raise ClusterError(f"{node.name}: info never answered "
                               f"within {deadline_s}s")
        return int(doc["info"]["ledger"]["num"])

    def min_lcl(self, nodes: Optional[List[ClusterNode]] = None) -> int:
        return min(self.lcl(n)
                   for n in (nodes if nodes is not None else self.nodes))

    def wait_slot(self, target: int, deadline_s: float,
                  nodes: Optional[List[ClusterNode]] = None) -> None:
        """Every given node externalizes ledger >= target — the shared
        round-robin waiter, so a lagging node only burns its own
        budget and the failure names the node that actually stalled."""
        def step(node: ClusterNode) -> bool:
            try:
                return node.get("info", timeout=1.0) \
                    .get("info", {}).get("ledger", {}) \
                    .get("num", 0) >= target
            except (OSError, ValueError, ClusterError):
                return False

        stragglers = self._await_all(
            list(nodes if nodes is not None else self.nodes),
            deadline_s, step)
        if stragglers:
            raise ClusterError(
                "never externalized ledger %d: %s" % (target, ", ".join(
                    f"{n.name} (at {self._lcl_or_unknown(n)})"
                    for n in stragglers)))

    def _lcl_or_unknown(self, node: ClusterNode):
        """Best-effort LCL for error messages: ONE short request — the
        node just proved unresponsive, a retried poll per straggler
        would stack minutes onto an already-failed wait."""
        try:
            return int(node.get("info", timeout=1.0)
                       ["info"]["ledger"]["num"])
        except (OSError, ValueError, ClusterError, KeyError):
            return "unknown"

    # ---------------------------------------------------------------- load --
    def generate_load(self, node: ClusterNode, mode: str,
                      **params) -> dict:
        return node.get("generateload", {"mode": mode, **{
            k: str(v) for k, v in params.items()}},
            timeout=max(REQUEST_TIMEOUT_S, 30.0))

    def submit_tx(self, node: ClusterNode, envelope_b64: str) -> dict:
        """Submit one base64-XDR TransactionEnvelope over the `tx`
        route (the raw-operator path beside generateload; the smoke
        test drives a hand-built envelope through it)."""
        return node.get("tx", {"blob": envelope_b64})

    def drain_pending(self, node: ClusterNode,
                      deadline_s: float = 60.0) -> bool:
        """Poll until the node's pending tx queue is empty (all load
        externalized or expired)."""
        deadline = time.monotonic() + deadline_s
        return node.poll(
            "info", deadline=deadline,
            ok=lambda d: d.get("info", {}).get("num_pending_txs", 1)
            == 0) is not None

    # --------------------------------------------------------------- chaos --
    def install_chaos(self, node: ClusterNode, seed: int,
                      schedule: List[dict]) -> dict:
        """Install a seeded fault schedule on ONE process over the
        `chaos` route (requires the rendered ALLOW_CHAOS_INJECTION)."""
        return node.get("chaos", {
            "mode": "install", "seed": str(seed),
            "schedule": json.dumps(schedule)})

    def clear_chaos(self, node: ClusterNode) -> None:
        node.get("chaos", {"mode": "clear"})

    # ------------------------------------------------ wide-area faults --
    # Schedule builders return {node_name: [spec, ...]} so callers can
    # merge several fault families before installing: `chaos
    # ?mode=install` REPLACES the node's engine, so every fault a node
    # must carry has to travel in ONE schedule (merge_schedules +
    # install_schedules).
    def cut_edges(self, minority: List[ClusterNode]
                  ) -> List[tuple]:
        """The topology edges crossing minority <-> rest — the link
        set a partition of `minority` must sever."""
        cut_ids = {n.node_id for n in minority}
        edges = []
        for a, b, _kind in self.links:
            if (a in cut_ids) != (b in cut_ids):
                edges.append((self._by_id[a], self._by_id[b]))
        return edges

    @staticmethod
    def _link_fault(kind: str, other: ClusterNode, **extra) -> dict:
        spec = {"point": "overlay.link", "kind": kind,
                "match": {"peer": other.node_id.hex()}}
        spec.update(extra)
        return spec

    def partition_schedules(self, minority: List[ClusterNode],
                            window_s: float
                            ) -> Dict[str, List[dict]]:
        """`overlay.link` partition specs for BOTH endpoints of every
        edge crossing the cut: the next send on a severed link drops
        the connection, and `peer_authenticated` refuses re-dials
        while the window is open. Heals by window elapse (window_s=0:
        only an explicit chaos?mode=clear heals)."""
        per_node: Dict[str, List[dict]] = {}
        for na, nb in self.cut_edges(minority):
            per_node.setdefault(na.name, []).append(
                self._link_fault("partition", nb, window_s=window_s))
            per_node.setdefault(nb.name, []).append(
                self._link_fault("partition", na, window_s=window_s))
        return per_node

    def flap_schedules(self, edges: List[tuple], window_s: float,
                       period_s: float = 3.0, duty: float = 0.4
                       ) -> Dict[str, List[dict]]:
        """`overlay.link` flap specs (periodic down/up inside the
        window) on both endpoints of each given edge."""
        per_node: Dict[str, List[dict]] = {}
        for na, nb in edges:
            for src, dst in ((na, nb), (nb, na)):
                per_node.setdefault(src.name, []).append(
                    self._link_fault("flap", dst, window_s=window_s,
                                     period_s=period_s, duty=duty))
        return per_node

    def shape_schedules(self, latency, window_s: float = 0.0
                        ) -> Dict[str, List[dict]]:
        """`overlay.send` slow_link specs from a
        ``topologies.LinkLatency`` model — the per-link
        latency/bandwidth shapes, ported off loopback onto the real
        TCP sockets. Both endpoints shape their outbound side of the
        link, so the WAN delay applies in each direction."""
        per_node: Dict[str, List[dict]] = {}
        for a, b, kind in self.links:
            delay_s, bps = latency.for_link(kind)
            na, nb = self._by_id[a], self._by_id[b]
            for src, dst in ((na, nb), (nb, na)):
                spec = {"point": "overlay.send", "kind": "slow_link",
                        "delay_ms": delay_s * 1000.0,
                        "window_s": window_s,
                        "match": {"peer": dst.node_id.hex()}}
                if bps is not None:
                    # LinkLatency speaks bits/s (the loopback port
                    # divides by 8 too); the chaos Shape wants bytes/s
                    spec["bps"] = float(bps) / 8.0
                per_node.setdefault(src.name, []).append(spec)
        return per_node

    @staticmethod
    def merge_schedules(*per_node_dicts: Dict[str, List[dict]]
                        ) -> Dict[str, List[dict]]:
        merged: Dict[str, List[dict]] = {}
        for d in per_node_dicts:
            for name, specs in d.items():
                merged.setdefault(name, []).extend(specs)
        return merged

    def install_schedules(self, per_node: Dict[str, List[dict]],
                          seed: int) -> int:
        """ONE chaos install per named node (install replaces the
        engine — merged schedules only). Returns specs installed."""
        by_name = {n.name: n for n in self.nodes}
        total = 0
        for name, specs in per_node.items():
            self.install_chaos(by_name[name], seed, specs)
            total += len(specs)
        return total

    def clear_all_chaos(self) -> None:
        for node in self.nodes:
            if node.alive:
                try:
                    self.clear_chaos(node)
                except (OSError, ValueError, ClusterError):
                    pass

    # ---------------------------------------------------------- recording --
    def record_all(self) -> Dict[str, str]:
        """Arm streaming input recording on every live node
        (`recordstart?path=<data_dir>/input.rec`, the flight
        recorder): a failed matrix cell keeps each node's replay log
        next to its sqlite/bucket state. Best-effort — a node already
        recording (restart) just keeps its existing log."""
        paths: Dict[str, str] = {}
        for node in self.nodes:
            if not node.alive:
                continue
            path = os.path.join(node.data_dir, "input.rec")
            try:
                node.get("recordstart", {"path": path})
                paths[node.name] = path
            except (OSError, ValueError, ClusterError):
                if os.path.exists(path):
                    paths[node.name] = path   # armed on a prior boot
        return paths

    def recordstop_all(self) -> None:
        """Seal every node's streaming record (writes the END frame so
        replay knows the log is complete, not truncated by a crash)."""
        for node in self.nodes:
            if node.alive:
                try:
                    node.get("recordstop")
                except (OSError, ValueError, ClusterError):
                    pass

    def flow_report(self, deadline_s: float = 15.0) -> dict:
        """Per-link outbound backpressure evidence off the `peers`
        route: cluster-wide queue high-water vs the byte
        budget, plus per-class shed totals. The verdicts the
        backpressure cell gates on: a slow peer's queue never exceeds
        its budget, and SCP is never shed while lower classes were
        available to shed (the drop-priority contract — scp drops
        require gossip+tx shed first, so scp_dropped stays 0 in every
        matrix cell)."""
        docs = self._sweep("peers", None, deadline_s,
                           ok=lambda d: "authenticated_peers" in d)
        high = 0
        budget = 0
        drops = {"scp": 0, "tx": 0, "gossip": 0}
        for _name, doc in docs.items():
            if doc is None:
                continue
            peers = doc["authenticated_peers"]
            for row in peers.get("inbound", []) + \
                    peers.get("outbound", []):
                fl = row.get("flow") or {}
                high = max(high, int(fl.get("queue_high_water", 0)))
                budget = int(fl.get("queue_budget", 0)) or budget
                for cls, n in (fl.get("drops") or {}).items():
                    if cls in drops:
                        drops[cls] += int(n)
        return {
            "queue_high_water_max": high,
            "queue_budget": budget,
            "drops": drops,
            "within_budget": budget == 0 or high <= budget,
            "scp_never_shed_first": drops["scp"] == 0
            or (drops["tx"] + drops["gossip"]) > 0,
        }

    # ------------------------------------------------------------ verdicts --
    def _sweep(self, command: str, params: Optional[dict],
               deadline_s: float,
               ok: Callable[[dict], bool]) -> Dict[str, Optional[dict]]:
        """Round-robin collection from every live node against ONE
        shared deadline: each pass gives each pending node one short
        request, so a single wedged node can only lose its own verdict
        — never eat the budget of the nodes polled after it (the
        Tail-at-Scale discipline, applied to collection)."""
        out: Dict[str, Optional[dict]] = {
            n.name: None for n in self.nodes}

        def step(node: ClusterNode) -> bool:
            try:
                doc = node.get(command, params, timeout=1.0)
                if ok(doc):
                    out[node.name] = doc
                    return True
            except (OSError, ValueError, ClusterError):
                pass
            return False

        self._await_all([n for n in self.nodes if n.alive],
                        deadline_s, step)
        return out

    def collect_clusterstatus(self, deadline_s: float = 20.0,
                              headers: Optional[str] = None
                              ) -> Dict[str, Optional[dict]]:
        """One deadline-bounded sweep: every live node's clusterstatus
        document (None for nodes that never answered — the caller's
        verdict decides what a silent node means)."""
        docs = self._sweep("clusterstatus",
                           {"headers": headers} if headers else None,
                           deadline_s,
                           ok=lambda d: "clusterstatus" in d)
        return {name: (doc["clusterstatus"] if doc else None)
                for name, doc in docs.items()}

    def headers_agree(self, upto: int,
                      statuses: Dict[str, Optional[dict]],
                      expected: Optional[int] = None) -> bool:
        """Byte-identical honest-survivor chains over [2, upto] — the
        byzantine.py verdict, fed from HTTP-collected header maps.
        `expected` pins how many chains MUST be present: agreement
        among the two nodes that happened to answer says nothing
        about the six that timed out."""
        chains = {}
        for name, doc in statuses.items():
            if doc is None:
                continue
            hdrs = doc.get("headers", {})
            chains[name] = [hdrs.get(str(seq), "")
                            for seq in range(2, upto + 1)]
        if expected is not None and len(chains) < expected:
            return False
        return header_chains_agree(chains)

    def flood_report(self, deadline_s: float = 15.0) -> dict:
        """Aggregate flood redundancy + per-peer byte counters from
        every live node's `peers` route (the bench _flood_report shape,
        collected over HTTP)."""
        from ..overlay.manager import (finalize_flood_evidence,
                                       merge_flood_evidence)
        docs = self._sweep("peers", None, deadline_s,
                           ok=lambda d: "authenticated_peers" in d)
        unique = dup = bytes_sent = bytes_recv = 0
        per_peer = []
        demand: dict = {}
        encode: dict = {}
        by_kind: dict = {}
        by_name = {n.name: n for n in self.nodes}
        for name, doc in docs.items():
            node = by_name[name]
            if doc is None:
                continue
            peers = doc["authenticated_peers"]
            flood = peers.get("flood") or {}
            unique += flood.get("unique", 0)
            dup += flood.get("duplicates", 0)
            # wire-path evidence, per node over HTTP:
            # single-flight demand totals, encode-cache efficiency
            # and the SCP-vs-tx dedup split
            merge_flood_evidence(demand, flood.get("demand"))
            merge_flood_evidence(encode, flood.get("encode"))
            merge_flood_evidence(by_kind, flood.get("by_kind"))
            for row in peers.get("inbound", []) + \
                    peers.get("outbound", []):
                bytes_sent += row["bytes_sent"]
                bytes_recv += row["bytes_received"]
                per_peer.append({
                    "node": node.name, "peer": row["id"][:12],
                    "bytes_sent": row["bytes_sent"],
                    "bytes_received": row["bytes_received"],
                    "messages_sent": row["messages_sent"],
                    "messages_received": row["messages_received"],
                    "duplicates": row["duplicates"],
                })
        finalize_flood_evidence(demand, encode)
        return {
            "unique": unique,
            "duplicates": dup,
            "duplicate_ratio": round(dup / max(1, unique), 4),
            "bytes_sent_total": bytes_sent,
            "bytes_received_total": bytes_recv,
            "per_peer_bytes": per_peer,
            "demand": demand,
            "encode": encode,
            "by_kind": by_kind,
        }

    # ----------------------------------------------------------- telemetry --
    # stored samples per node are capped: the node-side ring is already
    # bounded, but an incremental scrape accumulates across the whole
    # run — a long soak must not grow the harness without bound either
    MAX_SAMPLES_PER_NODE = 10_000

    def poll_timeseries(self, deadline_s: float = 15.0) -> int:
        """One incremental telemetry sweep (the `timeseries` route's
        since=<cursor> contract): each live node is asked only for
        samples newer than the cursor the previous sweep returned.
        A node that restarted (new epoch) or evicted past the cursor
        answers reset=true with its full ring — the harness drops its
        stale tail and resyncs. Returns the number of new samples."""
        new = [0]

        def step(node: ClusterNode) -> bool:
            try:
                params = {"since": node.ts_token} if node.ts_token \
                    else None
                doc = node.get("timeseries", params, timeout=1.0)
            except (OSError, ValueError, ClusterError):
                return False
            ts = doc.get("timeseries")
            if ts is None:
                return False
            if ts.get("reset") and node.ts_token is not None:
                node.ts_resets += 1
            samples = ts.get("samples", [])
            for s in samples:
                s["node"] = node.name
            node.ts_samples.extend(samples)
            if len(node.ts_samples) > self.MAX_SAMPLES_PER_NODE:
                node.ts_samples = \
                    node.ts_samples[-self.MAX_SAMPLES_PER_NODE:]
            node.ts_token = ts.get("cursor")
            new[0] += len(samples)
            return True

        self._await_all([n for n in self.nodes if n.alive],
                        deadline_s, step)
        return new[0]

    def series_summary(self) -> dict:
        """Cluster-wide bounded series summary (the CLUSTER artifact
        form): per-node summaries plus the aggregate envelope."""
        from ..util.timeseries import (aggregate_summaries,
                                       summarize_samples)
        per_node = {n.name: summarize_samples(n.ts_samples)
                    for n in self.nodes}
        out = aggregate_summaries(list(per_node.values()))
        out["per_node"] = per_node
        out["scrape_resets"] = sum(n.ts_resets for n in self.nodes)
        return out

    def collect_controller(self, deadline_s: float = 15.0) -> dict:
        """Sweep every live node's `controller` route: the
        adaptive control plane's live knob values, shed levels, and
        decision tallies, merged into per-node docs plus cluster-wide
        shed/tune totals for the CLUSTER artifact."""
        docs = self._sweep("controller", None, deadline_s,
                           ok=lambda d: "controller" in d)
        per_node = {}
        totals = {"tx_dropped": 0, "flood_dropped": 0,
                  "tune_up": 0, "tune_down": 0, "shed_changes": 0}
        for name, doc in docs.items():
            c = doc.get("controller") if doc else None
            if c is None:
                per_node[name] = None
                continue
            per_node[name] = {
                "knobs": c.get("knobs"),
                "shed": c.get("shed"),
                "frozen": c.get("frozen"),
                "ticks": c.get("ticks"),
            }
            shed = c.get("shed") or {}
            dec = c.get("decisions") or {}
            totals["tx_dropped"] += shed.get("tx_dropped", 0)
            totals["flood_dropped"] += shed.get("flood_dropped", 0)
            totals["tune_up"] += dec.get("tune_up", 0)
            totals["tune_down"] += dec.get("tune_down", 0)
            totals["shed_changes"] += dec.get("shed_changes", 0)
        return {"per_node": per_node, "totals": totals}

    def collect_backend(self, deadline_s: float = 15.0) -> dict:
        """Sweep every live node's `backendstatus` route:
        aggregate breaker state, the surviving-mesh summary and the
        per-device breaker rows, merged into per-node docs plus
        cluster-wide degradation totals for the CLUSTER artifact. A
        node without a supervised device backend reports None."""
        docs = self._sweep("backendstatus", None, deadline_s,
                           ok=lambda d: "backend" in d
                           or "exception" in d)
        per_node = {}
        totals = {"devices": 0, "active": 0, "open_devices": 0,
                  "quarantined": 0}
        for name, doc in docs.items():
            b = (doc or {}).get("backend")
            if b is None:
                per_node[name] = None
                continue
            mesh = b.get("mesh") or {}
            per_node[name] = {
                "state": b.get("state"),
                "mesh": mesh,
                "devices": [
                    {k: d.get(k) for k in ("device", "state",
                                           "consecutive_failures",
                                           "dispatches", "skips")}
                    for d in b.get("devices", [])],
                "failures": b.get("failures"),
                "transition_count": b.get("transition_count"),
            }
            totals["devices"] += mesh.get("devices", 0)
            totals["active"] += mesh.get("active", 0)
            totals["open_devices"] += sum(
                1 for d in b.get("devices", [])
                if d.get("state") == "OPEN")
            totals["quarantined"] += len(b.get("quarantined", []))
        return {"per_node": per_node, "totals": totals}

    def collect_slo(self, deadline_s: float = 15.0) -> dict:
        """Sweep every live node's `slo` route and aggregate: worst
        verdict per rule across the cluster, breach tallies summed,
        plus each node's own composite verdict."""
        from ..ops.slo import aggregate_status
        docs = self._sweep("slo", None, deadline_s,
                           ok=lambda d: "slo" in d)
        statuses = {name: (doc["slo"] if doc else None)
                    for name, doc in docs.items()}
        out = aggregate_status([s for s in statuses.values() if s])
        out["per_node"] = {
            name: (s.get("overall") if s else None)
            for name, s in statuses.items()}
        return out

    # ------------------------------------------------------------- tracing --
    def start_tracing(self) -> None:
        for node in self.nodes:
            if node.alive:
                node.get("starttrace")

    def merged_trace(self, deadline_s: float = 30.0) -> dict:
        """Collect every live node's `dumptrace` export and stitch them
        into one cluster-wide Chrome trace (wall-clock-aligned process
        lanes, cross-node flood flow chains)."""
        from ..util.tracemerge import merge_trace_docs
        collected = self._sweep("dumptrace", None, deadline_s,
                                ok=lambda d: "trace" in d)
        docs, labels = [], []
        for node in self.nodes:
            doc = collected.get(node.name)
            if doc is not None:
                docs.append(doc["trace"])
                labels.append(node.name)
        return merge_trace_docs(docs, labels=labels)


def _free_ports(n: int) -> List[int]:
    """OS-assigned free TCP ports for the overlay listeners. All
    sockets are held open until every port is drawn, so one call can't
    hand out duplicates. Known limitation: unlike HTTP_PORT=0 (bound
    by the node itself, race-free), overlay ports must be rendered
    into every neighbor's KNOWN_PEERS before any node boots — probe
    and bind are therefore separated by seconds, and another process
    can steal a port in between. The loss is LOUD, not silent: the
    node fails to bind, dies during boot, and wait_ready raises with
    the node's log path."""
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


# --------------------------------------------------------------- scenario --
def bad_sig_flood_schedule(flooder_hex: str, burst: int = 6
                           ) -> List[dict]:
    """The cluster chaos schedule (JSON form, installed over HTTP on
    every honest node): each TRANSACTION body received from the
    flooder grows a burst of forged bad-signature twins — the
    byzantine.py flood modeled at the receiving seam."""
    return [{"point": "overlay.transaction.recv",
             "kind": "bad_sig_flood", "start": 0, "count": 1_000_000,
             "burst": burst, "match": {"peer": flooder_hex}}]


def run_cluster_scenario(root_dir: str, n_orgs: int = 3,
                         validators_per_org: int = 3,
                         close_time: float = 0.5,
                         target_slots: int = 5,
                         load_accounts: int = 100,
                         load_rounds: int = 3,
                         txs_per_round: int = 300,
                         chaos: bool = True, churn: bool = True,
                         chaos_seed: int = 9,
                         trace: bool = False,
                         trace_path: Optional[str] = None,
                         boot_deadline_s: float = 180.0,
                         log_level: str = "warning") -> dict:
    """The full harness scenario (bench --tps-cluster / the slow test):
    boot a tiered process-per-node cluster over real TCP, measure pay
    TPS over the wire, run the chaos leg (seeded bad-sig flood over
    HTTP + a real kill -9 churn with catchup over the wire), and
    collect all verdicts from the admin APIs. Returns the CLUSTER
    artifact core (bench adds metric/host_load wrapping)."""
    import time as _wall

    n_nodes = n_orgs * validators_per_org
    cluster = Cluster(n_orgs, validators_per_org, root_dir,
                      close_time=close_time, log_level=log_level)
    wall0 = _wall.perf_counter()
    result: dict = {"nodes": n_nodes,
                    "topology": f"tiered {n_orgs}x{validators_per_org}"}
    with cluster:
        cluster.start_all(boot_deadline_s)
        cluster.wait_mesh(60.0 + 5.0 * n_nodes)
        cluster.wait_slot(2, 60.0)
        node0 = cluster.nodes[0]
        result["boot_wall_s"] = round(_wall.perf_counter() - wall0, 1)

        # ---- load phase: accounts, then measured pay rounds --------
        cluster.generate_load(node0, "create", accounts=load_accounts)
        cluster.wait_slot(cluster.lcl(node0) + 2, 60.0)
        if trace:
            cluster.start_tracing()
        applied = 0
        t0 = time.monotonic()
        for _ in range(load_rounds):
            r = cluster.generate_load(node0, "pay", txs=txs_per_round)
            applied += int(r.get("submitted", 0))
            if not cluster.drain_pending(node0, 90.0):
                raise ClusterError("load never drained from node0")
            # node0's queue drained at its CURRENT tip: every other
            # node must close that same ledger before the round's
            # clock stops — the measured rate covers the full
            # wire+consensus+apply pipeline on the SLOWEST node, not
            # just the submitter
            cluster.wait_slot(cluster.lcl(node0), 90.0)
            # incremental telemetry scrape per load round: the ring is
            # bounded node-side, so waiting for one final sweep could
            # lose the run's early samples on a long leg
            cluster.poll_timeseries(10.0)
        dt = time.monotonic() - t0
        tps = applied / dt if dt else 0.0
        result["tps"] = round(tps, 1)
        result["applied"] = applied
        result["load_wall_s"] = round(dt, 1)
        if trace:
            merged = cluster.merged_trace()
            result["trace_events"] = len(merged.get("traceEvents", []))
            if trace_path:
                # the inspectable artifact is the point of the merge —
                # the sibling benches all write trace_*.json too
                with open(trace_path, "w") as f:
                    json.dump(merged, f)
                result["trace_path"] = trace_path

        # ---- chaos leg: bad-sig flood over HTTP ---------------------
        if chaos:
            flooder = cluster.nodes[-1]
            honest = [n for n in cluster.nodes if n is not flooder]
            for node in honest:
                cluster.install_chaos(
                    node, chaos_seed,
                    bad_sig_flood_schedule(flooder.node_id.hex()))
            # template traffic must ORIGINATE at the flooder so the
            # receivers' seam attributes the forged burst to it; pay
            # txs (one op = one TRANSACTION frame each) give the seam
            # enough templates to push every direct neighbor past the
            # drop threshold — a CREATE batch is just one frame
            cluster.generate_load(flooder, "create", accounts=8)
            cluster.wait_slot(cluster.lcl(flooder) + 2, 60.0)
            cluster.generate_load(flooder, "pay", txs=30)

            def flooder_dropped(d) -> bool:
                cs = d.get("clusterstatus", {})
                return cs.get("peers", {}).get("drop_reasons", {}) \
                    .get("bad sig flood", 0) > 0
            # round-robin sweep: only the flooder's direct topology
            # neighbors receive frames attributed to it, so ANY honest
            # node tripping the threshold passes — and no single
            # never-tripping node may burn the shared deadline
            deadline = time.monotonic() + 60.0
            dropped_on = None
            while dropped_on is None and time.monotonic() < deadline:
                for node in honest:
                    try:
                        if flooder_dropped(node.get("clusterstatus",
                                                    timeout=1.0)):
                            dropped_on = node.name
                            break
                    except (OSError, ValueError, ClusterError):
                        pass
                if dropped_on is None:
                    honest[0].jittered_sleep(POLL_BASE_S * 3)
            # cumulative drop counter off the `metrics` route — the
            # per-peer counter on `peers` dies with each dropped
            # connection (the flooder re-dials with a fresh Peer), so
            # only the aggregate survives to the final sweep
            bad_sig_total = 0
            deadline = time.monotonic() + 15.0
            for node in honest:
                doc = node.poll("metrics", deadline=deadline,
                                ok=lambda d: "metrics" in d)
                if doc is not None:
                    bad_sig_total += doc["metrics"].get(
                        "overlay.peer.drop.bad_sig", {}).get("count", 0)
            result["chaos"] = {
                "kind": "bad_sig_flood",
                "flooder": flooder.name,
                "flooder_dropped": dropped_on is not None,
                "dropped_on": dropped_on,
                "bad_sig_drops": bad_sig_total,
            }

        # ---- churn leg: REAL kill -9, restart, catchup over the wire
        if churn:
            victim = cluster.nodes[1]
            # survivors = honest nodes only: the just-dropped flooder
            # may legitimately lag or stall, and it must neither gate
            # the survivors' liveness check nor drag net_lcl down to
            # its stale tip (a false-pass catchup verdict)
            survivors = [n for n in cluster.nodes
                         if n is not victim
                         and not (chaos and n is cluster.nodes[-1])]
            lcl_at_kill = cluster.lcl(victim)
            t_churn = time.monotonic()
            cluster.kill_node(victim)
            # the survivors must keep externalizing without the victim
            cluster.wait_slot(lcl_at_kill + 2, 90.0, nodes=survivors)
            cluster.restart_node(victim, deadline_s=90.0)
            net_lcl = cluster.min_lcl(survivors)
            caught = victim.poll(
                "info", deadline=time.monotonic() + 120.0,
                ok=lambda d: d.get("info", {}).get("ledger", {})
                .get("num", 0) >= net_lcl) is not None
            result["churn"] = {
                "victim": victim.name,
                "lcl_at_kill": lcl_at_kill,
                "network_lcl_at_restart": net_lcl,
                "caught_up": caught,
                "recovery_wall_s": round(
                    time.monotonic() - t_churn, 1),
            }

        # ---- verdict sweep ------------------------------------------
        # honest survivors (the byzantine.py semantics): the flooder's
        # neighbors legitimately dropped it, so — like the in-process
        # scenarios — it is excluded from the agreement/liveness/
        # health verdicts; everyone else must hold them
        honest_nodes = [n for n in cluster.nodes
                        if not (chaos and n is cluster.nodes[-1])]
        cluster.wait_slot(2 + target_slots, 120.0, nodes=honest_nodes)
        live = [n for n in honest_nodes if n.alive]
        upto = cluster.min_lcl(live)
        honest_names = {n.name for n in honest_nodes}
        statuses = cluster.collect_clusterstatus(
            30.0, headers=f"2-{upto}")
        per_node = {}
        clusterstatus_ok = True
        for name, doc in statuses.items():
            if doc is None:
                if name in honest_names:
                    clusterstatus_ok = False
                per_node[name] = {"clusterstatus_ok": False}
                continue
            per_node[name] = {
                "clusterstatus_ok": True,
                "healthy": doc.get("healthy", False),
                "ledger": doc.get("ledger", {}).get("num", 0),
                "close": doc.get("close", {}),
                "tx_e2e": doc.get("tx_e2e", {}),
            }
            if name in honest_names:
                clusterstatus_ok &= bool(doc.get("healthy"))
        safety_ok = cluster.headers_agree(
            upto, {k: v for k, v in statuses.items()
                   if k in honest_names},
            expected=len(honest_nodes))
        result["flood"] = cluster.flood_report()
        # final telemetry sweep + the merged cluster-wide series
        # summary and SLO verdict section (the CLUSTER
        # artifact carries the time dimension, not just endpoints)
        cluster.poll_timeseries(15.0)
        result["timeseries"] = cluster.series_summary()
        result["slo"] = cluster.collect_slo(15.0)
        # adaptive control plane state per node: knob
        # positions, shed levels and decision tallies ride the
        # artifact beside the series they were derived from
        result["controller"] = cluster.collect_controller(15.0)
        # per-device breaker state per node: surviving-mesh
        # summaries and per-device dispatch/skip evidence
        result["backend"] = cluster.collect_backend(15.0)
        result["verdicts"] = per_node
        result["clusterstatus_ok"] = clusterstatus_ok
        result["safety_ok"] = safety_ok
        result["slots_externalized"] = upto
        result["liveness_ok"] = upto >= 2 + target_slots
        # graceful teardown (the SIGTERM satellite): every node drains
        # its completion queue and exits 0
        rcs = cluster.stop_all(graceful=True)
        result["graceful_shutdown_ok"] = all(
            rc == 0 for rc in rcs.values())
        result["shutdown_rcs"] = rcs
    result["wall_seconds"] = round(_wall.perf_counter() - wall0, 1)
    result["ok"] = bool(
        result.get("safety_ok") and result.get("liveness_ok")
        and result.get("clusterstatus_ok")
        and (not chaos or result["chaos"]["flooder_dropped"])
        and (not churn or result["churn"]["caught_up"])
        and result.get("graceful_shutdown_ok"))
    return result


# ---------------------------------------------------- scenario matrix --
def run_matrix_cell(root_dir: str, cell: dict) -> dict:
    """One cell of the wide-area survival matrix: boot a
    real-process tiered mesh, drive the cell's load shape (uniform or
    Zipf-skewed, optional surge burst), overlay its fault legs
    (partition / flap / slow-link / sick-device — any subset), and
    return a TYPED verdict doc the MATRIX artifact schema checks
    per-cell:

    - ``survival_ok`` — the quorum-holding side kept externalizing
      through every fault window and no node process crashed;
    - ``rejoin_ok`` — every partitioned/flapped-out node caught back
      up to the network LCL within the cell's bounded rejoin window
      (vacuously true for cells without a link fault);
    - ``safety_ok`` — byte-identical header chains across ALL live
      nodes over the common prefix (the byzantine.py verdict), which
      is what makes a rejoin count: agreeing late is still agreeing;
    - ``slo_ok`` — the cluster-wide SLO aggregate did not BREACH;
    - ``crashes`` — node processes dead at verdict time (must be 0:
      a minority partition STALLS safely, it never dies).

    Every node records its input stream (`recordstart`) so a
    failing cell ships per-node replay logs in ``record_paths``."""
    import time as _wall

    name = cell["name"]
    n_orgs = int(cell.get("n_orgs", 3))
    vpo = int(cell.get("validators_per_org", 1))
    n_nodes = n_orgs * vpo
    close_time = float(cell.get("close_time", 1.0))
    target_slots = int(cell.get("target_slots", 3))
    seed = int(cell.get("chaos_seed", 20))
    cluster = Cluster(n_orgs, vpo, root_dir, close_time=close_time,
                      log_level=cell.get("log_level", "warning"))
    wall0 = _wall.perf_counter()
    doc: dict = {"name": name, "nodes": n_nodes,
                 "topology": f"tiered {n_orgs}x{vpo}",
                 "survival_ok": False, "rejoin_ok": True,
                 "safety_ok": False, "slo_ok": False,
                 "crashes": n_nodes, "ok": False, "faults": []}
    survival_ok = True
    rejoin_ok = True
    with cluster:
        cluster.start_all(float(cell.get("boot_deadline_s", 240.0)))
        cluster.wait_mesh(90.0 + 5.0 * n_nodes)
        cluster.wait_slot(2, 120.0)
        if cell.get("record", True):
            doc["record_paths"] = cluster.record_all()
        node0 = cluster.nodes[0]

        # ---- load phase: the cell's traffic shape ------------------
        cluster.generate_load(node0, "create",
                              accounts=int(cell.get("accounts", 40)))
        cluster.wait_slot(cluster.lcl(node0) + 2, 120.0)
        load_mode = cell.get("load", "uniform")
        txs_per_round = int(cell.get("txs_per_round", 80))
        applied = 0
        t0 = time.monotonic()
        for _ in range(int(cell.get("rounds", 1))):
            if load_mode == "zipf":
                r = cluster.generate_load(
                    node0, "zipf", txs=txs_per_round,
                    exponent=float(cell.get("zipf_exponent", 1.2)))
            else:
                r = cluster.generate_load(node0, "pay",
                                          txs=txs_per_round)
            applied += int(r.get("submitted", 0))
            if not cluster.drain_pending(node0, 180.0):
                raise ClusterError(f"{name}: load never drained")
            cluster.wait_slot(cluster.lcl(node0), 180.0)
        dt = time.monotonic() - t0
        doc["tps"] = round(applied / dt, 1) if dt else 0.0
        doc["applied"] = applied

        # ---- surge leg: one oversized burst ------------------------
        surge = int(cell.get("surge", 0))
        if surge:
            doc["faults"].append("surge")
            cluster.generate_load(node0, "pay", txs=surge)
            if not cluster.drain_pending(node0, 240.0):
                survival_ok = False
            else:
                cluster.wait_slot(cluster.lcl(node0), 180.0)

        # ---- slow-link leg: WAN shapes on the real sockets ---------
        sl = cell.get("slow_link")
        if sl:
            doc["faults"].append("slow_link")
            latency = topologies.LinkLatency(
                seed=int(sl.get("seed", 7)),
                intra_org_ms=float(sl.get("intra_org_ms", 2.0)),
                cross_org_ms=tuple(sl.get("cross_org_ms",
                                          (30.0, 120.0))),
                bandwidth_bps=sl.get("bps"))
            cluster.install_schedules(
                cluster.shape_schedules(
                    latency, window_s=float(sl.get("window_s", 0.0))),
                seed)
            lcl0 = cluster.lcl(node0)
            cluster.generate_load(node0, "pay",
                                  txs=int(sl.get("txs", 60)))
            try:
                # shaped links are slow, not dead: consensus must keep
                # externalizing under the WAN delays
                cluster.wait_slot(lcl0 + 2, 300.0)
            except ClusterError:
                survival_ok = False
            cluster.clear_all_chaos()

        # ---- flap leg: one node's links cycle down/up under load ---
        fl = cell.get("flap")
        if fl:
            doc["faults"].append("flap")
            window = float(fl.get("window_s", 10.0))
            victim = cluster.nodes[-1]
            others = [n for n in cluster.nodes if n is not victim]
            cluster.install_schedules(
                cluster.flap_schedules(
                    [(victim, nb) for nb in victim.neighbors],
                    window,
                    period_s=float(fl.get("period_s", 3.0)),
                    duty=float(fl.get("duty", 0.4))),
                seed + 1)
            lcl0 = cluster.min_lcl(others)
            cluster.generate_load(node0, "pay",
                                  txs=int(fl.get("txs", 60)))
            try:
                cluster.wait_slot(lcl0 + 2, 240.0, nodes=others)
            except ClusterError:
                survival_ok = False
            # let the windows elapse everywhere, then heal explicitly
            # (belt and braces) and require the flapped node to catch
            # back up — a flapping WAN link must degrade, not detach
            time.sleep(window)
            cluster.clear_all_chaos()
            net = cluster.min_lcl(others)
            caught = victim.poll(
                "info", deadline=time.monotonic()
                + float(fl.get("rejoin_s", 150.0)),
                ok=lambda d: d.get("info", {}).get("ledger", {})
                .get("num", 0) >= net)
            if caught is None:
                rejoin_ok = False

        # ---- partition leg: cut one org off the quorum -------------
        pt = cell.get("partition")
        if pt:
            doc["faults"].append("partition")
            window = float(pt.get("window_s", 10.0))
            minority = cluster.nodes[:vpo]           # org 0, < top tier
            majority = cluster.nodes[vpo:]
            maj0 = majority[0]
            cluster.install_schedules(
                cluster.partition_schedules(minority, window),
                seed + 2)
            # traffic originates on the MAJORITY side: the partition
            # fires at the send/dial seams, so the cut links must see
            # sends — SCP traffic alone would do it, load makes it
            # immediate
            cluster.generate_load(maj0, "create", accounts=8)
            lcl0 = cluster.min_lcl(majority)
            try:
                cluster.wait_slot(lcl0 + 3, 240.0, nodes=majority)
            except ClusterError:
                survival_ok = False
            # the minority must STALL SAFELY: still alive, no crash.
            # ONE short request per stalled node — they just lost
            # their quorum, a retried poll would burn the cell budget
            mlcls = []
            for n in minority:
                v = cluster._lcl_or_unknown(n)
                mlcls.append(v if isinstance(v, int) else 0)
            doc["partition"] = {
                "window_s": window,
                "minority": [n.name for n in minority],
                "majority_lcl_mid": cluster.min_lcl(majority),
                "minority_alive_mid": all(n.alive for n in minority),
                "minority_lcl_mid": min(mlcls),
            }
            if not doc["partition"]["minority_alive_mid"]:
                survival_ok = False
            # heal: let every window elapse, clear any remainder, and
            # re-knit the mesh (jittered dial retry + connect nudges)
            time.sleep(window)
            cluster.clear_all_chaos()
            try:
                cluster.wait_mesh(120.0 + 5.0 * n_nodes)
            except ClusterError:
                rejoin_ok = False
            net = cluster.min_lcl(majority)
            rejoin_deadline = time.monotonic() \
                + float(pt.get("rejoin_s", 180.0))
            t_heal = time.monotonic()
            for n in minority:
                ok_doc = n.poll(
                    "info", deadline=rejoin_deadline,
                    ok=lambda d: d.get("info", {}).get("ledger", {})
                    .get("num", 0) >= net)
                if ok_doc is None:
                    rejoin_ok = False
            doc["partition"]["rejoin_wall_s"] = round(
                time.monotonic() - t_heal, 1)
            doc["partition"]["network_lcl_at_heal"] = net

        # ---- sick-device leg: trip one node's accel breaker --------
        sd = cell.get("sick_device")
        if sd:
            doc["faults"].append("sick_device")
            sick = cluster.nodes[-1]
            tripped = False
            try:
                sick.get("backendstatus", {"action": "trip"})
                tripped = True
            except (OSError, ValueError, ClusterError):
                pass    # no supervised backend on this build: the leg
                        # still asserts plain survival
            lcl0 = cluster.lcl(node0)
            try:
                cluster.wait_slot(lcl0 + 2, 180.0)
            except ClusterError:
                survival_ok = False
            time.sleep(float(sd.get("hold_s", 2.0)))
            if tripped:
                try:
                    sick.get("backendstatus", {"action": "reset"})
                except (OSError, ValueError, ClusterError):
                    pass
            doc["sick_device"] = {"node": sick.name,
                                  "tripped": tripped}

        # ---- verdict sweep -----------------------------------------
        try:
            cluster.wait_slot(2 + target_slots, 240.0)
        except ClusterError:
            survival_ok = False
        live = [n for n in cluster.nodes if n.alive]
        doc["crashes"] = n_nodes - len(live)
        upto = cluster.min_lcl(live)
        statuses = cluster.collect_clusterstatus(45.0,
                                                 headers=f"2-{upto}")
        safety_ok = cluster.headers_agree(upto, statuses,
                                          expected=len(live))
        flood = cluster.flood_report()
        doc["duplicate_ratio"] = flood.get("duplicate_ratio", 0.0)
        doc["flood"] = {k: flood[k] for k in
                        ("unique", "duplicates", "duplicate_ratio")}
        doc["flow"] = cluster.flow_report()
        slo = cluster.collect_slo(20.0)
        doc["slo"] = {"overall": slo.get("overall"),
                      "nodes": slo.get("nodes", 0)}
        doc["slots"] = upto
        cluster.recordstop_all()
        rcs = cluster.stop_all(graceful=True)
        doc["graceful_shutdown_ok"] = all(
            rc == 0 for rc in rcs.values())
    doc["survival_ok"] = bool(survival_ok and doc["crashes"] == 0)
    # a rejoin only COUNTS when the rejoined chain is byte-identical
    # to the survivors' — agreeing late is still agreeing; diverging
    # after a heal is the failure this matrix exists to catch
    doc["safety_ok"] = bool(safety_ok)
    doc["rejoin_ok"] = bool(rejoin_ok and safety_ok)
    doc["slo_ok"] = slo.get("overall") != "BREACH"
    doc["wall_s"] = round(_wall.perf_counter() - wall0, 1)
    doc["ok"] = bool(
        doc["survival_ok"] and doc["rejoin_ok"] and doc["safety_ok"]
        and doc["slo_ok"] and doc["flow"]["within_budget"]
        and doc["flow"]["scp_never_shed_first"]
        and doc["graceful_shutdown_ok"])
    return doc
