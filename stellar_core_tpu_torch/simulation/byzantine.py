"""Adversarial (Byzantine) multinode scenarios: equivocating SCP votes,
invalid-signature floods against the verify service, malformed XDR on
the wire, and node churn with catchup-under-chaos.

Mazières 2015 (PAPERS.md) specifies what SCP must survive: safety under
*ill-behaved* nodes, not just crashed ones. The chaos scenarios
(simulation/chaos.py) cover the honest-but-faulty family; this module is
the adversarial counterpart on the tiered 50–100-node topologies
(simulation/topologies.py). Verdict semantics differ from chaos.py in
one key way: with a Byzantine proposer in the mix, the externalized
values legitimately DIFFER from a fault-free run (the equivocator's
forged twin can win a slot), so **safety is honest-survivor agreement**
— every honest node's header chain byte-identical to every other
honest node's — not equality with a baseline leg.

Scenario shapes:

- ``run_smoke`` — the tier-1 acceptance leg: a 9-node tiered quorum
  (3 orgs × 3) with one equivocator and one bad-sig flooder; honest
  nodes must externalize ≥ `target_slots` slots with byte-identical
  headers while the flooder gets dropped by per-peer accounting.
- ``run_tiered_chaos`` — the `slow` leg: 50+ nodes (orgs + watcher
  tier) with the per-link latency model, equivocation, bad-sig flood,
  a malformed-XDR window, and churn: a validator is killed mid-close
  (`SimulatedChurn`), restarted from its persisted DB + bucket dir a
  few slots later, and must catch back up over the overlay while the
  equivocator is still active.
- ``run_byzantine_bench`` — the ``bench.py --byzantine`` artifact:
  measured slots-to-externalize under equivocation (vs a clean leg),
  verify-service throughput under the bad-sig flood, and churn
  recovery time.
"""

from __future__ import annotations

import time as _wall
from typing import Dict, List, Optional

from ..crypto.keys import SecretKey, clear_verify_cache
from ..herder.tx_queue import AddResult
from ..tx.frame import make_frame
from ..util import chaos
from ..util.chaos import ChaosEngine, FaultSpec, SimulatedCrash
from ..util.logging import get_logger
from ..xdr.ledger_entries import Asset, AssetType, LedgerKey
from ..xdr.transaction import (DecoratedSignature, Memo, MemoType,
                               MuxedAccount, Operation, OperationType,
                               PaymentOp, Preconditions, PreconditionType,
                               Transaction, TransactionEnvelope,
                               TransactionV1Envelope, _OperationBody,
                               _TxExt)
from ..xdr.types import EnvelopeType
from . import topologies
# crash/churn-aware crank loop shared with the honest-but-faulty
# scenarios (one copy: simulation/chaos.py)
from .chaos import _crank_with_crashes as _crank_byz

log = get_logger("Chaos")

FIRST_LOADED_LEDGER = 3


def _configure(threshold: int = 16):
    def conf(cfg):
        # pinned close times + synchronous merges: deterministic,
        # reproducible runs (docs/CHAOS.md determinism contract)
        cfg.ARTIFICIALLY_SET_CLOSE_TIME_FOR_TESTING = 1
        cfg.ARTIFICIALLY_PESSIMIZE_MERGES_FOR_TESTING = True
        # per-peer flooder accounting trips fast enough to matter
        # within a short scenario (satellite: PEER_BAD_SIG_DROP_THRESHOLD)
        cfg.PEER_BAD_SIG_DROP_THRESHOLD = threshold
        # telemetry on the shared VirtualClock: one sample
        # per virtual second per node feeds the BYZ artifact's
        # time-series summary + SLO verdicts — deterministic, since
        # the scenario clock is seeded-virtual
        cfg.TELEMETRY_SAMPLE_PERIOD = 1.0
    return conf


def _prep(sim) -> None:
    for app in sim.apps():
        # inline completion: deterministic chaos hit ordinals
        app.ledger_manager.defer_completion = False


def _install_verify_stack(app, clock) -> None:
    """Batch verifier + coalescing verify service on one node, host
    dispatch only (device_min_batch beyond any batch — the Byzantine
    verdicts must not depend on kernel builds). The flood admission path
    then rides the service exactly as in production."""
    from ..ops.verifier import CudaBatchVerifier
    from ..ops.verify_service import VerifyService
    bv = CudaBatchVerifier(perf=app.perf, device_min_batch=1 << 20)
    app.batch_verifier = bv
    app.herder.batch_verifier = bv
    app.verify_service = VerifyService(bv, clock=clock,
                                       metrics=app.metrics,
                                       perf=app.perf)
    app.herder.verify_service = app.verify_service


class _TargetedPayer:
    """Per-ledger root self-payment submitted to ONE node (the flood
    template source): the tx propagates to everyone else over the real
    advert/demand/TRANSACTION path, which is exactly the wire the
    bad-sig flooder rides."""

    def __init__(self, sim, target_app):
        self.sim = sim
        self.network_id = target_app.config.network_id()
        self.key = SecretKey.from_seed(self.network_id)
        self.target = target_app
        from ..ledger.ledger_txn import LedgerTxn
        from ..xdr.types import PublicKey
        with LedgerTxn(target_app.ledger_manager.root) as ltx:
            le = ltx.load_without_record(LedgerKey.account(
                PublicKey.ed25519(self.key.public_key().raw)))
            self.seq = le.data.value.seqNum
        self.submitted = 0

    def submit_one(self) -> AddResult:
        self.seq += 1
        muxed = MuxedAccount.from_ed25519(self.key.public_key().raw)
        tx = Transaction(
            sourceAccount=muxed, fee=100, seqNum=self.seq,
            cond=Preconditions(PreconditionType.PRECOND_NONE),
            memo=Memo(MemoType.MEMO_NONE),
            operations=[Operation(sourceAccount=None, body=_OperationBody(
                OperationType.PAYMENT, PaymentOp(
                    destination=muxed,
                    asset=Asset(AssetType.ASSET_TYPE_NATIVE),
                    amount=1)))],
            ext=_TxExt(0))
        env = TransactionEnvelope(
            EnvelopeType.ENVELOPE_TYPE_TX,
            TransactionV1Envelope(tx=tx, signatures=[]))
        probe = make_frame(env, self.network_id)
        env.value.signatures = [DecoratedSignature(
            hint=self.key.public_key().hint(),
            signature=self.key.sign(probe.contents_hash()))]
        frame = make_frame(env, self.network_id)
        res = self.target.herder.recv_transactions([frame])[0]
        if res not in (AddResult.ADD_STATUS_PENDING,
                       AddResult.ADD_STATUS_DUPLICATE):
            raise RuntimeError(f"byzantine load tx rejected: {res}")
        self.submitted += 1
        return res




def _restart_and_catch_up(sim, node: bytes, honest: List[bytes]) -> dict:
    """Resurrect a churned node from persisted state and crank until it
    reaches the honest tip — catchup-under-chaos (any installed
    schedule keeps firing). Returns the churn evidence dict."""
    t0 = sim.clock.now()
    lcl_before = sim.nodes[node].ledger_manager \
        .get_last_closed_ledger_num()
    app = sim.restart_node(node)
    app.ledger_manager.defer_completion = False
    _install_verify_stack(app, sim.clock)
    net_lcl = max(sim.nodes[n].ledger_manager
                  .get_last_closed_ledger_num()
                  for n in honest if n not in sim.crashed)
    caught = sim.crank_until(
        lambda: app.ledger_manager.get_last_closed_ledger_num()
        >= net_lcl, timeout_virtual_seconds=300.0)
    return {
        "node": node.hex(),
        "lcl_at_restart": lcl_before,
        "network_lcl_at_restart": net_lcl,
        "caught_up": bool(caught),
        "recovery_virtual_s": round(sim.clock.now() - t0, 3),
    }


def _honest_hashes(sim, honest: List[bytes], upto: int
                   ) -> Dict[bytes, List[bytes]]:
    out: Dict[bytes, List[bytes]] = {}
    for nid in honest:
        if nid in sim.crashed:
            continue
        app = sim.nodes[nid]
        hashes = []
        for seq in range(2, upto + 1):
            row = app.database.query_one(
                "SELECT ledgerhash FROM ledgerheaders WHERE ledgerseq=?",
                (seq,))
            hashes.append(bytes(row[0]) if row else b"")
        out[nid] = hashes
    return out


def header_chains_agree(hashes: Dict) -> bool:
    """THE honest-survivor safety verdict (module docstring): every
    surviving honest node's header chain complete (no missing rows)
    and byte-identical to every other's. Chains may be lists of raw
    bytes (in-process scenarios) or hex strings (the multi-process
    cluster harness collecting `clusterstatus?headers=` over HTTP) —
    a missing header is the falsy value either way."""
    chains = list(hashes.values())
    return bool(chains) and all(h for h in chains[0]) and \
        all(c == chains[0] for c in chains[1:])


# internal alias kept for the scenario runners below
_honest_agree = header_chains_agree


def byzantine_schedule(eq_hex: str, flooder_hex: str,
                       burst: int = 8) -> List[FaultSpec]:
    """The canonical 2-adversary schedule: `eq_hex` equivocates on
    every SCP emit; every honest node receiving a TRANSACTION body
    from `flooder_hex` gets a burst of forged bad-sig twins attached
    (modeling the flooder's own sends)."""
    return [
        FaultSpec("scp.emit", "equivocate", start=0, count=1_000_000,
                  match={"node": eq_hex}),
        FaultSpec("overlay.transaction.recv", "bad_sig_flood", start=0,
                  count=1_000_000, burst=burst,
                  match={"peer": flooder_hex}),
    ]


def run_smoke(seed: int = 7, target_slots: int = 5, burst: int = 8,
              bad_sig_threshold: int = 16,
              with_faults: bool = True) -> dict:
    """9-node tiered smoke (tier-1 acceptance): 1 equivocator + 1
    bad-sig flooder; honest nodes externalize ≥ `target_slots` slots
    with byte-identical headers, the flooder is dropped by per-peer
    accounting, and the verify service absorbs the flood."""
    clear_verify_cache()
    sim = topologies.tiered(3, 3, configure=_configure(bad_sig_threshold))
    _prep(sim)
    ids = list(sim.nodes.keys())
    equivocator = ids[4]       # org 1, validator 1
    flooder = ids[8]           # org 2, validator 2
    honest = [n for n in ids if n not in (equivocator, flooder)]
    eng = None
    if with_faults:
        eng = ChaosEngine(seed, byzantine_schedule(
            equivocator.hex(), flooder.hex(), burst=burst))
        chaos.install(eng)
    wall0 = _wall.perf_counter()
    try:
        sim.start_all_nodes()
        for app in sim.apps():
            _install_verify_stack(app, sim.clock)
        if not sim.crank_until(lambda: sim.have_all_externalized(2),
                               timeout_virtual_seconds=60.0):
            raise RuntimeError("network never closed ledger 2")
        chaos_t0 = sim.clock.now()
        payer = _TargetedPayer(sim, sim.nodes[flooder])
        target = 2 + target_slots

        def honest_at(seq):
            return all(sim.nodes[n].ledger_manager
                       .get_last_closed_ledger_num() >= seq
                       for n in honest if n not in sim.crashed)

        for seq in range(FIRST_LOADED_LEDGER, target + 1):
            payer.submit_one()
            _crank_byz(sim, lambda s=seq: honest_at(s), timeout=120.0)
            if not honest_at(seq):
                raise RuntimeError(
                    f"liveness lost: honest nodes stalled before {seq}")
        virtual_elapsed = sim.clock.now() - chaos_t0
        hashes = _honest_hashes(sim, honest, target)
        bad_sig_total = sum(
            sim.nodes[n].metrics.new_counter(
                "overlay.peer.drop.bad_sig").count for n in honest)
        flood_dropped = any(
            sim.nodes[n].overlay_manager.drop_reasons.get(
                "bad sig flood", 0) > 0 for n in honest)
        svc = [sim.nodes[n].verify_service.stats() for n in honest]
        # merged honest-node telemetry + SLO verdicts: the
        # BYZ artifact carries the run's time dimension, not just the
        # end-state figures
        from ..util.timeseries import scenario_reports
        telemetry, slo = scenario_reports(
            [sim.nodes[n] for n in honest if n not in sim.crashed])
        return {
            "timeseries": telemetry,
            "slo": slo,
            "ok": _honest_agree(hashes),
            "liveness_ok": True,
            "safety_ok": _honest_agree(hashes),
            "slots": target_slots,
            "virtual_seconds": round(virtual_elapsed, 3),
            "virtual_s_per_slot": round(
                virtual_elapsed / target_slots, 3),
            "wall_seconds": round(_wall.perf_counter() - wall0, 1),
            "equivocator": equivocator.hex(),
            "flooder": flooder.hex(),
            "flooder_dropped": flood_dropped,
            "bad_sig_drops": bad_sig_total,
            "verify_submitted": sum(s["submitted"] for s in svc),
            "verify_flushes": sum(s["flushes"] for s in svc),
            "injected": dict(eng.injected) if eng else {},
        }
    finally:
        if with_faults:
            chaos.uninstall()
        sim.stop_all_nodes()


def run_tiered_chaos(seed: int = 11, n_orgs: int = 3,
                     validators_per_org: int = 12, watchers: int = 14,
                     target_slots: int = 4, data_dir: str = None,
                     churn_down_slots: int = 2,
                     bad_sig_threshold: int = 16,
                     burst: int = 6) -> dict:
    """The `slow` 50+-node leg: tiered quorum + watcher tier with the
    per-link latency model, equivocation + bad-sig flood + a
    malformed-XDR window, and CHURN: one validator is killed mid-close
    by a `churn` fault, restarted from persisted state
    `churn_down_slots` slots later, and must catch back up over the
    overlay while the equivocator is still active."""
    if data_dir is None:
        raise ValueError("run_tiered_chaos needs a data_dir for churn")
    clear_verify_cache()
    sim = topologies.tiered(
        n_orgs, validators_per_org, watchers=watchers,
        configure=_configure(bad_sig_threshold), data_dir=data_dir,
        latency=topologies.LinkLatency(seed))
    _prep(sim)
    ids = list(sim.nodes.keys())
    n_validators = n_orgs * validators_per_org
    equivocator = ids[validators_per_org + 1]        # org 1
    flooder = ids[2 * validators_per_org + 2]        # org 2
    victim = ids[1]                                  # org 0, validator 1
    honest = [n for n in ids[:n_validators]
              if n not in (equivocator, flooder)]
    schedule = byzantine_schedule(equivocator.hex(), flooder.hex(),
                                  burst=burst)
    # churn: kill the victim inside its 3rd loaded close, mid-apply —
    # the close transaction rolls back, restart resumes from the
    # previous durable header
    schedule.append(FaultSpec("ledger.close.crash.applyTx", "churn",
                              start=2, count=1,
                              match={"node": victim.hex()}))
    # malformed XDR window: a few of the equivocator's transport sends
    # are truncated/mangled — receivers kill the link through the
    # standard malformed-message drop path
    schedule.append(FaultSpec("overlay.send", "malformed_xdr",
                              start=40, count=3,
                              match={"node": equivocator.hex()}))
    eng = ChaosEngine(seed, schedule)
    chaos.install(eng)
    wall0 = _wall.perf_counter()
    churned: List[bytes] = []
    restart_evidence = None
    try:
        sim.start_all_nodes()
        for app in sim.apps():
            _install_verify_stack(app, sim.clock)
        if not sim.crank_until(lambda: sim.have_all_externalized(2),
                               timeout_virtual_seconds=300.0):
            raise RuntimeError("network never closed ledger 2")
        payer = _TargetedPayer(sim, sim.nodes[flooder])
        target = 2 + target_slots

        def honest_at(seq):
            return all(sim.nodes[n].ledger_manager
                       .get_last_closed_ledger_num() >= seq
                       for n in honest if n not in sim.crashed)

        restart_due_at = None
        for seq in range(FIRST_LOADED_LEDGER, target + 1):
            payer.submit_one()
            _crank_byz(sim, lambda s=seq: honest_at(s), timeout=600.0,
                       churned=churned)
            if not honest_at(seq):
                raise RuntimeError(
                    f"liveness lost: honest nodes stalled before {seq}")
            if churned and restart_due_at is None:
                restart_due_at = seq + churn_down_slots
            if restart_due_at is not None and seq >= restart_due_at \
                    and churned[0] in sim.crashed:
                # catchup-under-chaos: the equivocator is still firing
                # while the restarted node resyncs over the overlay
                restart_evidence = _restart_and_catch_up(
                    sim, churned[0], honest)
        if not churned:
            raise RuntimeError("churn fault never fired")
        if restart_evidence is None and churned[0] in sim.crashed:
            # churn fired on the last slot: restart + catch up now
            restart_evidence = _restart_and_catch_up(
                sim, churned[0], honest)
        # the restarted node rejoins the honest set for the safety
        # verdict: its post-catchup chain must match everyone else's
        survivors = [n for n in honest if n not in sim.crashed]
        check_upto = min(sim.nodes[n].ledger_manager
                         .get_last_closed_ledger_num()
                         for n in survivors + churned
                         if n not in sim.crashed)
        hashes = _honest_hashes(sim, survivors + churned, check_upto)
        flood_dropped = any(
            sim.nodes[n].overlay_manager.drop_reasons.get(
                "bad sig flood", 0) > 0
            for n in honest if n not in sim.crashed)
        return {
            "ok": (_honest_agree(hashes) and
                   bool(restart_evidence and
                        restart_evidence["caught_up"])),
            "nodes": len(ids),
            "validators": n_validators,
            "watchers": watchers,
            "safety_ok": _honest_agree(hashes),
            "liveness_ok": True,
            "churn": restart_evidence,
            "flooder_dropped": flood_dropped,
            "injected": dict(eng.injected),
            "virtual_seconds": round(sim.clock.now(), 1),
            "wall_seconds": round(_wall.perf_counter() - wall0, 1),
        }
    finally:
        chaos.uninstall()
        sim.stop_all_nodes()


def run_byzantine_bench(seed: int = 7) -> dict:
    """``bench.py --byzantine`` artifact: all figures MEASURED in this
    process — slots-to-externalize under equivocation vs a clean run
    of the same topology, verify-service throughput under the bad-sig
    flood (valid+forged submissions over the faulted leg's wall time),
    and churn recovery time on a 9-node tiered network with persisted
    node state."""
    import shutil
    import tempfile

    clean = run_smoke(seed=seed, with_faults=False)
    byz = run_smoke(seed=seed, with_faults=True)
    flood_wall = byz["wall_seconds"]
    verify_tput = round(byz["verify_submitted"] / flood_wall, 1) \
        if flood_wall else None
    clean_tput = round(clean["verify_submitted"] /
                       clean["wall_seconds"], 1) \
        if clean["wall_seconds"] else None
    root = tempfile.mkdtemp(prefix="byz-churn-")
    try:
        churn = run_tiered_chaos(
            seed=seed + 1, n_orgs=3, validators_per_org=3, watchers=0,
            target_slots=6, data_dir=root, churn_down_slots=1)
    except (Exception, SimulatedCrash) as e:      # noqa: BLE001
        churn = {"ok": False, "error": repr(e)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ok = bool(byz["ok"] and byz["flooder_dropped"] and
              churn.get("ok"))
    return {
        "metric": "byzantine_convergence",
        "value": 1.0 if ok else 0.0,
        "unit": "pass",
        "vs_baseline": 1.0 if ok else 0.0,
        "slots_to_externalize": {
            "clean_virtual_s_per_slot": clean["virtual_s_per_slot"],
            "byzantine_virtual_s_per_slot": byz["virtual_s_per_slot"],
            "slowdown": round(byz["virtual_s_per_slot"] /
                              clean["virtual_s_per_slot"], 3)
            if clean["virtual_s_per_slot"] else None,
        },
        "verify_under_flood": {
            "submitted": byz["verify_submitted"],
            "flushes": byz["verify_flushes"],
            "verifies_per_s_wall": verify_tput,
            "clean_verifies_per_s_wall": clean_tput,
            "bad_sig_drops": byz["bad_sig_drops"],
            "flooder_dropped": byz["flooder_dropped"],
        },
        "churn": {
            "recovery_virtual_s":
                (churn.get("churn") or {}).get("recovery_virtual_s"),
            "caught_up": (churn.get("churn") or {}).get("caught_up"),
            "safety_ok": churn.get("safety_ok"),
        },
        "smoke": {k: byz[k] for k in
                  ("ok", "safety_ok", "injected", "virtual_seconds")},
        "tiered_churn": churn,
        # the faulted leg's merged time-series summary + SLO section
        # (the artifact contract, linted by check_artifacts)
        "timeseries": byz.get("timeseries", {"samples": 0}),
        "slo": byz.get("slo", {"overall": "OK", "rules": {}}),
    }
