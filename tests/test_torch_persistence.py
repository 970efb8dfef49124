"""The JAX package's own persistence and close tests, rebound to the port.

tests/test_bucket.py, test_ledger_txn.py, test_ledger_txn_edges.py,
test_postgres.py (over the wire-protocol stub, db/pg_stub.py),
test_ledger_close.py, test_parallel_apply.py and the node-free tests of
test_close_pipeline.py run twice: as written, and with their names
rebound to the port's modules (tests/torch_rebind.py, which also rebinds
the helpers they take from txtest_utils, test_ledger_close and
test_ledger_txn). Each run records, in order, every LedgerTxn commit (its
delta's key and entry bytes and its header's bytes) and every
LedgerManager.close_ledger (the closed header's bytes and hash, or the
error), and, as a multiset, the hash of every Bucket made (merges run on
background threads); the two records must be equal. Fixtures get each
package's own objects: `root` an in-memory or a SQL root, `tmp_path` a
directory per run, `pg_uri` a stub server per run. SecretKey.random
draws the same seeded keys in both runs.

Left out, because they need a module the port does not have yet (named
in ROADMAP.md Queue 1): the TransactionQueue tests of test_ledger_close
(herder/tx_queue.py), the Application and simulation tests of
test_parallel_apply, test_close_pipeline and test_postgres, and
test_close_pipeline's DNS-cache test (overlay/manager.py).
"""

import contextlib
import hashlib
import inspect

import pytest

import test_bucket as ref_bucket
import test_close_pipeline as ref_close_pipeline
import test_ledger_close as ref_ledger_close
import test_ledger_txn as ref_ledger_txn
import test_ledger_txn_edges as ref_ledger_txn_edges
import test_parallel_apply as ref_parallel_apply
import test_postgres as ref_postgres
from torch_rebind import (Unported, helper_module, jax_case, port_case,
                          rebound, reference_cases)
from torch_tx_parity import J, P, clear_caches

# reference test -> the unported module it needs
LEFT_OUT = {
    "test_ledger_close": {
        "test_tx_queue_lifecycle": "herder/tx_queue.py",
        "test_tx_queue_eviction_by_fee": "herder/tx_queue.py",
        "test_tx_queue_two_phase_eviction_no_partial_drop":
            "herder/tx_queue.py"},
    "test_parallel_apply": {
        "test_app_differential_with_soroban_and_zipf":
            "main/application.py, simulation/",
        "test_zipf_loadgen_is_seed_deterministic_and_hot":
            "main/application.py, simulation/",
        "test_sim_pair_with_thread_checks_and_parallel_apply":
            "main/application.py, simulation/"},
    "test_close_pipeline": {
        "test_crash_mid_completion_restart": "main/application.py",
        "test_publish_records_queue_time_has": "main/application.py",
        "test_gc_keeps_buckets_of_queued_checkpoint": "main/application.py",
        "test_dns_cache_ttl_and_no_failure_caching": "overlay/manager.py"},
    "test_postgres": {
        "test_factory_selects_backend": "main/config.py",
        "test_node_boots_and_closes_ledgers_on_postgres":
            "main/application.py",
        "test_restart_recovers_lcl_on_postgres": "main/application.py"},
}
MODULES = (ref_bucket, ref_ledger_txn, ref_ledger_txn_edges, ref_postgres,
           ref_ledger_close, ref_parallel_apply, ref_close_pipeline)


def _callable(module, owner, name):
    return getattr(module, name) if owner is None \
        else getattr(getattr(module, owner), name)


def _cases():
    """reference_cases of every module, leaving out LEFT_OUT, with a
    case per root kind for the tests that take the `root` fixture."""
    out = []
    for module in MODULES:
        for p in reference_cases(module, LEFT_OUT.get(module.__name__, {})):
            module_, owner, name, kw = p.values[0]
            if "root" in inspect.signature(
                    _callable(module_, owner, name)).parameters:
                out += [pytest.param((module_, owner, name,
                                      dict(kw, root=kind)),
                                     id=f"{p.id}[{kind}]")
                        for kind in ("memory", "sql")]
            else:
                out.append(p)
    return out


CASES = _cases()


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_caches()
    yield
    clear_caches()


@contextlib.contextmanager
def recording(pkg):
    """Record every LedgerTxn commit, close_ledger and Bucket of `pkg`,
    with SecretKey.random drawing seeded keys; yields (ordered, bucket
    hashes)."""
    ordered, buckets = [], []
    ltx_cls = pkg.ledger_txn.LedgerTxn
    lm_cls = pkg.ledger_manager.LedgerManager
    bucket_cls = pkg.bucket.Bucket
    sk_cls = pkg.keys.SecretKey
    saved = (ltx_cls.commit, lm_cls.close_ledger, bucket_cls.__init__,
             vars(sk_cls)["random"])
    commit, close_ledger, bucket_init, _ = saved
    drawn = iter(range(1 << 30))

    def recorded_commit(self):
        ordered.append(("commit", sorted(
            (kb, None if e is None else e.to_bytes())
            for kb, e in self._delta.items()),
            None if self._header is None else self._header.to_bytes()))
        return commit(self)

    def recorded_close(self, *args, **kwargs):
        try:
            out = close_ledger(self, *args, **kwargs)
        except Exception as e:
            ordered.append(("close", type(e).__name__, str(e)))
            raise
        ordered.append(("close",
                        self.get_last_closed_ledger_header().to_bytes(),
                        self.get_last_closed_ledger_hash()))
        return out

    def recorded_bucket(self, *args, **kwargs):
        bucket_init(self, *args, **kwargs)
        buckets.append(self.hash)

    def seeded(cls):
        return cls.from_seed(hashlib.sha256(
            b"rebound key %d" % next(drawn)).digest())

    ltx_cls.commit = recorded_commit
    lm_cls.close_ledger = recorded_close
    bucket_cls.__init__ = recorded_bucket
    sk_cls.random = classmethod(seeded)
    try:
        yield ordered, buckets
    finally:
        (ltx_cls.commit, lm_cls.close_ledger, bucket_cls.__init__,
         sk_cls.random) = saved


def _fixtures(pkg, fn, kw, tmp, stack):
    """The case's keyword arguments with `pkg`'s own fixture values."""
    args = dict(kw)
    params = inspect.signature(fn).parameters
    if "root" in params:
        if kw["root"] == "memory":
            args["root"] = pkg.ledger_txn.InMemoryLedgerTxnRoot()
        else:
            db = pkg.database.Database(":memory:")
            db.initialize()
            args["root"] = pkg.ledger_txn.LedgerTxnRoot(db)
    if "tmp_path" in params:
        args["tmp_path"] = tmp / pkg.name
        args["tmp_path"].mkdir()
    if "pg_uri" in params:
        srv = pkg.pg_stub.PGStubServer().start()
        stack.callback(srv.stop)
        args["pg_uri"] = srv.url()
    return args


def run_both(case, tmp_path):
    """The case on the JAX package, then on the port: each run's records."""
    module, owner, name, kw = case
    runs = []
    for pkg, make in ((J, jax_case), (P, port_case)):
        clear_caches()
        with contextlib.ExitStack() as stack, recording(pkg) as (o, b):
            fn = make(module, owner, name)
            fn(**_fixtures(pkg, fn, kw, tmp_path, stack))
        runs.append((o, sorted(b)))
    return runs


@pytest.mark.parametrize("case", CASES)
def test_reference_persistence_tests_on_both_with_equal_runs(case,
                                                             tmp_path):
    jax_run, port_run = run_both(case, tmp_path)
    assert jax_run == port_run


def test_cases_cover_every_reference_test_but_the_left_out():
    """Every test function of the seven modules runs, or is named in
    LEFT_OUT with the unported module it needs."""
    names = {(c.values[0][0].__name__, c.values[0][2]) for c in CASES}
    for module in MODULES:
        for n in vars(module):
            if n.startswith("test_"):
                left = LEFT_OUT.get(module.__name__, {})
                assert ((module.__name__, n) in names) != (n in left), n
    assert len(CASES) == 148


def test_the_runs_record_closes_and_commits():
    """The recorder sees the closes of a reference test: the payment
    chain test closes one ledger after genesis, on both packages."""
    case = next(c.values[0] for c in CASES
                if c.values[0][2] == "test_close_with_payment_chain")
    jax_run, port_run = run_both(case, None)
    closes = [r for r in port_run[0] if r[0] == "close"]
    assert len(closes) == 1 and closes == \
        [r for r in jax_run[0] if r[0] == "close"]
    assert any(r[0] == "commit" and r[1] for r in port_run[0])


def test_rebinding_reaches_the_port_modules():
    g = rebound(ref_parallel_apply)
    from stellar_core_tpu_torch.ledger import parallel_apply
    assert g["partition_stages"] is parallel_apply.partition_stages
    assert g["make_manager"].__globals__["LedgerManager"] is \
        P.ledger_manager.LedgerManager
    assert g["op_payment"].__globals__["PaymentOp"] is \
        P.transaction.PaymentOp
    lc = helper_module(ref_ledger_close)
    assert g["close_with"] is lc.close_with
    assert rebound(ref_close_pipeline)["lc"] is lc
    assert rebound(ref_ledger_txn_edges)["_account_entry"] is \
        helper_module(ref_ledger_txn)._account_entry
    lm = lc.make_manager(invariants=False)
    assert isinstance(lm, P.ledger_manager.LedgerManager)
    lm.join_completion()


def test_unported_names_raise_only_when_used():
    """TransactionQueue and AddResult (herder/tx_queue.py) and
    Application (main/application.py) have no port module yet: they
    rebind to stand-ins that raise NotImplementedError when called or
    read, not when rebound."""
    g = rebound(ref_ledger_close)
    assert isinstance(g["TransactionQueue"], Unported)
    with pytest.raises(NotImplementedError, match="tx_queue"):
        g["TransactionQueue"]()
    with pytest.raises(NotImplementedError, match="tx_queue"):
        g["AddResult"].ADD_STATUS_PENDING
    app = rebound(ref_close_pipeline)["Application"]
    with pytest.raises(NotImplementedError, match="application"):
        app.create(None, None)
    with pytest.raises(NotImplementedError):
        port_case(ref_ledger_close, None, "test_tx_queue_lifecycle")()
