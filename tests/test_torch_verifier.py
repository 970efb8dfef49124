"""The whole slice: CudaBatchVerifier(device="cpu") against the port's
oracle and the JAX package's oracle (test_torch_verifier_jax.py holds it
against TpuBatchVerifier), plus its API (device SHA modes, bypass,
overrides, async handle, metrics, default device) and the two import
guards. Exact verdicts."""

import ast
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stellar_core_tpu.crypto import ed25519_ref as jref
from stellar_core_tpu.crypto.keys import SecretKey as JaxSecretKey
from stellar_core_tpu.ops import testvectors as jtv
from stellar_core_tpu_torch.crypto import ed25519_ref as tref
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.ops import ed25519_kernel as EK
from stellar_core_tpu_torch.ops import testvectors as ttv
from stellar_core_tpu_torch.ops import verifier as V

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_overrides(monkeypatch):
    monkeypatch.delenv("ED25519_DEVICE_SHA", raising=False)
    monkeypatch.delenv("VERIFY_DEVICE_MIN_BATCH", raising=False)


def _mk(n, msg_len=32, seed=0):
    items = []
    for i in range(n):
        sk = SecretKey.pseudo_random_for_testing(seed * 1000 + i)
        msg = hashlib.sha256(b"msg%d-%d" % (seed, i)).digest()[:msg_len]
        items.append((sk.public_key().raw, sk.sign(msg), msg))
    return items


def _oracle(items):
    return [tref.verify(p, s, m) for p, s, m in items]


@pytest.fixture(scope="module")
def corpus():
    items = ttv.make_differential_vectors(8, seed=31)
    want = _oracle(items)
    assert want == [jref.verify(p, s, m) for p, s, m in items]
    return items, want


@pytest.mark.parametrize("device_sha", [True, False])
def test_corpus_matches_oracles(corpus, device_sha):
    """device_sha on: the 32-byte-message subset (the whole adversarial
    tail) takes the msg32 path. Off: the whole corpus takes the host-k
    path, which is also what device_sha on does with mixed lengths."""
    items, want = corpus
    if device_sha:
        keep = [i for i, it in enumerate(items) if len(it[2]) == 32]
        items, want = [items[i] for i in keep], [want[i] for i in keep]
        assert len(items) > 30 and 0 < sum(want) < len(want)
    v = V.CudaBatchVerifier(device="cpu", device_sha=device_sha)
    assert v.verify_tuples(items) == want


def test_message_lengths():
    items = []
    for i, ln in enumerate((0, 1, 31, 32, 33, 100, 1000)):
        sk = SecretKey.pseudo_random_for_testing(7000 + i)
        msg = (bytes(range(256)) * 4)[:ln]
        items.append((sk.public_key().raw, sk.sign(msg), msg))
    items.append((items[3][0], items[3][1], items[3][2][:31] + b"!"))
    got = V.CudaBatchVerifier(device="cpu").verify_tuples(items)
    assert got == _oracle(items) == [True] * 7 + [False]


def test_device_sha_selects_entry(monkeypatch):
    calls = []
    for name in ("verify_kernel_msg32", "verify_kernel_full"):
        def spy(a, r, s, mk, _name=name):
            calls.append((_name, mk.numpy().copy()))
            return torch.zeros(a.shape[0], dtype=torch.bool)
        monkeypatch.setattr(EK, name, spy)
    m32 = _mk(2, seed=42)
    mixed = m32 + _mk(1, msg_len=5, seed=43)
    V.CudaBatchVerifier(device="cpu").verify_tuples(m32)
    V.CudaBatchVerifier(device="cpu").verify_tuples(mixed)
    V.CudaBatchVerifier(device="cpu", device_sha=False).verify_tuples(m32)
    assert [c[0] for c in calls] == ["verify_kernel_msg32",
                                     "verify_kernel_full",
                                     "verify_kernel_full"]
    # msg32 ships M itself; the host-k path ships k = H(R‖A‖M) mod L
    assert calls[0][1].tobytes() == b"".join(m for _, _, m in m32)
    for (_, got), items in ((calls[1], mixed), (calls[2], m32)):
        want = [tref.compute_k(s[:32], p, m).to_bytes(32, "little")
                for p, s, m in items]
        assert got.tobytes() == b"".join(want)


def test_small_batch_bypass(monkeypatch):
    def boom(*a):
        raise AssertionError("device path taken below the cutoff")
    monkeypatch.setattr(EK, "verify_kernel_msg32", boom)
    monkeypatch.setattr(EK, "verify_kernel_full", boom)
    items = _mk(3, seed=44)
    items[1] = (items[1][0], items[1][1], b"other")
    v = V.CudaBatchVerifier(device="cpu", device_min_batch=4)
    assert v.verify_tuples(items) == [True, False, True]
    v.set_device_min_batch(3)
    with pytest.raises(AssertionError, match="cutoff"):
        v.verify_tuples(items)
    v.set_device_min_batch(0)
    assert v._device_min_batch == 1


def test_env_overrides(monkeypatch):
    monkeypatch.setenv("ED25519_DEVICE_SHA", "0")
    monkeypatch.setenv("VERIFY_DEVICE_MIN_BATCH", "7")
    v = V.CudaBatchVerifier(device="cpu", device_sha=True,
                            device_min_batch=2)
    assert v._device_sha is False and v._device_min_batch == 7
    monkeypatch.setenv("ED25519_DEVICE_SHA", "1")
    assert V.CudaBatchVerifier(device="cpu", device_sha=False)._device_sha
    monkeypatch.delenv("ED25519_DEVICE_SHA")
    monkeypatch.delenv("VERIFY_DEVICE_MIN_BATCH")
    v = V.CudaBatchVerifier(device="cpu")
    assert v._device_sha is True and v._device_min_batch == 1


class _Metric:
    def __init__(self):
        self.values = []

    def update(self, v):
        self.values.append(v)


class _Registry:
    def __init__(self):
        self.m = {}

    def new_histogram(self, name):
        return self.m.setdefault(name, _Metric())

    new_timer = new_histogram


def test_async_handle_and_metrics():
    reg = _Registry()
    v = V.CudaBatchVerifier(device="cpu", metrics=reg)
    items = _mk(3, seed=45)
    pubs = np.frombuffer(b"".join(p for p, _, _ in items), np.uint8)
    sigs = np.frombuffer(b"".join(s for _, s, _ in items), np.uint8)
    handle = v.verify_batch_async(pubs, sigs, [m for _, _, m in items])
    assert callable(handle)
    first, second = handle(), handle()
    assert first.dtype == bool and first.tolist() == [True] * 3
    assert second.tolist() == first.tolist()
    assert reg.m["crypto.verify.dispatch.batch"].values == [3]
    assert reg.m["crypto.verify.dispatch.padding"].values == [0]
    wall = reg.m["crypto.verify.dispatch.wall"].values
    assert len(wall) == 1 and wall[0] >= 0
    # device 0 routes to verify_tuples_async (the bypass keeps it cheap)
    v.set_device_min_batch(len(items) + 1)
    assert v.verify_tuples_async_on(0, items)() == [True] * 3
    with pytest.raises(IndexError):
        v.verify_tuples_async_on(1, items)
    assert v.verify_tuples([]) == []
    assert v.verify_batch(pubs[:0], sigs[:0], []).shape == (0,)


def test_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.CudaBatchVerifier()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.resolve_device(None)


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """A CUDA tensor launches the kernel or raises: with the build
    failing (no nvcc), both wrappers raise instead of computing."""
    from stellar_core_tpu_torch.ops import _build, ladder as LD

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(_build, "lib", no_nvcc)
    monkeypatch.setattr(LD, "_check", lambda name, *ts: cuda)
    monkeypatch.setattr(EK, "_check", lambda name, *ts: cuda)
    z = torch.zeros((2, 32), dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="nvcc"):
        LD.ladder(z, z, z, z)
    with pytest.raises(RuntimeError, match="nvcc"):
        EK.prep(z, z, z, z, EK.MODE_K)


def test_cuda_verifier_builds_at_construction(monkeypatch, tmp_path):
    """A verifier on a card builds the kernels when it is constructed:
    with nvcc missing, building the node's stack raises before a
    supervisor exists, so no flush can be served from the host while
    the card idles. A CPU verifier builds nothing."""
    from stellar_core_tpu_torch.ops import _build
    from stellar_core_tpu_torch.ops.backend_supervisor import \
        BackendSupervisor

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        BackendSupervisor(V.CudaBatchVerifier(device="cuda"),
                          dispatch_deadline_ms=0)
    assert _build._lib is None and not list(tmp_path.iterdir())
    built = []
    monkeypatch.setattr(_build, "lib", lambda: built.append(1))
    V.CudaBatchVerifier(device="cpu")
    assert built == []
    V.CudaBatchVerifier(device="cuda")
    assert built == [1]


def test_differential_vectors_identical_to_jax_package():
    assert ttv.make_differential_vectors(6, seed=5) == \
        jtv.make_differential_vectors(6, seed=5)
    for i in (0, 3):
        a, b = SecretKey.pseudo_random_for_testing(i), \
            JaxSecretKey.pseudo_random_for_testing(i)
        assert a.public_key().raw == b.public_key().raw
        assert a.sign(b"m") == b.sign(b"m")



def test_chaos_seam_and_perf_zones_match_reference():
    """ops.verifier.batch fires before the bypass decision, so an
    injected io_error raises at any batch size; crypto.batchVerify
    wraps dispatch and again collect, crypto.batchVerify.native the
    bypass. The bypass side is held against JAX TpuBatchVerifier, whose
    bypass runs no XLA program."""
    from stellar_core_tpu.ops.verifier import TpuBatchVerifier
    from stellar_core_tpu.util import chaos as jchaos
    from stellar_core_tpu.util.perf import ZoneRegistry as JaxZones
    from stellar_core_tpu_torch.util import chaos as tchaos
    from stellar_core_tpu_torch.util.perf import ZoneRegistry
    items = _mk(3, seed=6)
    bad = (items[0][0], items[1][1], items[0][2])
    reports = []
    for chaos, zones, make in (
            (jchaos, JaxZones, lambda perf, n: TpuBatchVerifier(
                perf=perf, device_min_batch=n)),
            (tchaos, ZoneRegistry, lambda perf, n: V.CudaBatchVerifier(
                perf=perf, device="cpu", device_min_batch=n))):
        perf = zones()
        bypass = make(perf, 64)
        chaos.install(chaos.ChaosEngine(3, [chaos.FaultSpec(
            "ops.verifier.batch", "io_error", start=0, count=1)]))
        try:
            with pytest.raises(OSError):
                bypass.verify_tuples(items)
            assert bypass.verify_tuples(items + [bad]) == \
                [True] * 3 + [False]
        finally:
            chaos.uninstall()
        reports.append({k: v["count"] for k, v in perf.report().items()})
    assert reports[1] == reports[0] == {"crypto.batchVerify.native": 1}
    perf = ZoneRegistry()
    v = V.CudaBatchVerifier(perf=perf, device="cpu")
    handle = v.verify_tuples_async(items + [bad])
    assert perf.report()["crypto.batchVerify"]["count"] == 1
    assert handle() == [True] * 3 + [False]
    assert {k: r["count"] for k, r in perf.report().items()} == \
        {"crypto.batchVerify": 2}


def test_host_prepare_bytes_equal_reference(corpus):
    """v1 host prep: k, -A and the strict flags, byte for byte the JAX
    package's, through the native library and through the oracle."""
    from stellar_core_tpu.ops import verifier as jver
    items, want = corpus
    pubs = np.frombuffer(b"".join(p for p, _, _ in items),
                         np.uint8).reshape(-1, 32)
    sigs = np.frombuffer(b"".join(s for _, s, _ in items),
                         np.uint8).reshape(-1, 64)
    msgs = [m for _, _, m in items]
    for port_fn, ref_fn in ((V.host_prepare, jver.host_prepare),
                            (V._prep_python, jver._prep_python)):
        got, ref = port_fn(pubs, sigs, msgs), ref_fn(pubs, sigs, msgs)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and np.array_equal(g, r)
    k, neg_a, ok = V.host_prepare(pubs, sigs, msgs)
    k_py, neg_a_py, ok_py = V._prep_python(pubs, sigs, msgs)
    assert np.array_equal(ok, ok_py) and 0 < ok.sum() < len(items)
    assert np.array_equal(k[ok], k_py[ok])
    assert np.array_equal(neg_a[ok], neg_a_py[ok])
    assert not any(w and not o for w, o in zip(want, ok))


def test_v1_entry_matches_oracle():
    """verify_kernel (the Pallas ladder's v1 entry) on the 8 tuples of
    tests/test_tpu_verifier.py::test_pallas_ladder_interpret_matches_oracle
    (one S corrupted): host-prepped -A, the ladder, the compare."""
    items = _mk(8, seed=9)
    pubs = np.frombuffer(b"".join(p for p, _, _ in items),
                         dtype=np.uint8).reshape(-1, 32).copy()
    sigs = np.frombuffer(b"".join(s for _, s, _ in items),
                         dtype=np.uint8).reshape(-1, 64).copy()
    msgs = [m for _, _, m in items]
    sigs[3, 40] ^= 0x10
    k, neg_a, ok = V.host_prepare(pubs, sigs, msgs)
    assert ok.all()

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))
    got = EK.verify_kernel(t(sigs[:, 32:]), t(k), t(neg_a[:, :32]),
                           t(neg_a[:, 32:]), t(sigs[:, :32]))
    want = [tref.verify(bytes(pubs[i]), bytes(sigs[i]), msgs[i])
            for i in range(8)]
    assert (got & t(ok)).tolist() == want == [True] * 3 + [False] + \
        [True] * 4


# ------------------------------------------------------------ guards ----

_GUARD = r"""
import sys
before = set(sys.modules)
sys.path.insert(0, {root!r})
from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
from stellar_core_tpu_torch.ops.testvectors import make_differential_vectors
import stellar_core_tpu_torch.crypto.sha
import stellar_core_tpu_torch.native.loader
import stellar_core_tpu_torch.ops.backend_supervisor
import stellar_core_tpu_torch.ops.shard_math
import stellar_core_tpu_torch.ops.verify_service
from stellar_core_tpu_torch.ops.multihost import (HybridShardedVerifier,
                                                  make_hybrid_mesh)
from stellar_core_tpu_torch.ops.verifier import ShardedBatchVerifier
for name in ("checks", "logging", "threads", "timer", "cache", "tracing",
             "perf", "metrics", "chaos"):
    __import__("stellar_core_tpu_torch.util." + name)
from stellar_core_tpu_torch.crypto.keys import host_verifier
items = make_differential_vectors(2)
got = CudaBatchVerifier(device="cpu").verify_tuples(items[:3])
assert got == [True, True, False], got
assert host_verifier() == "native"
mesh = make_hybrid_mesh(["cpu"] * 2, n_hosts=2)
assert HybridShardedVerifier(mesh).verify_tuples(items[:1]) == [True]
assert ShardedBatchVerifier(["cpu"] * 2).ndev == 2
for name in ("xdr.runtime", "xdr.types", "xdr.ledger_entries",
             "xdr.transaction", "xdr.results", "xdr.scp", "xdr.ledger",
             "ledger.ledger_txn", "tx.tx_utils", "tx.sponsorship",
             "tx.operation_frame", "tx.signature_checker",
             "invariant.manager", "tx.frame", "tx.operations.payment_ops",
             "herder.surge_pricing", "herder.tx_set", "herder.herder",
             "crypto.strkey", "crypto.shorthash", "util.xdr_stream",
             "xdr.contract", "xdr.overlay", "xdr.next_types", "xdr.schema",
             "tx.operations", "tx.operations.account_ops",
             "tx.operations.misc_ops", "tx.pool_trust", "tx.offer_math",
             "tx.liabilities", "tx.operations.trust_ops",
             "tx.offer_exchange", "tx.operations.offer_ops",
             "tx.operations.path_payment_ops",
             "tx.operations.claimable_balance_ops",
             "tx.operations.clawback_ops", "tx.operations.sponsorship_ops",
             "tx.operations.liquidity_pool_ops", "invariant",
             "invariant.invariants", "tx.footprint",
             "soroban.network_config", "soroban.fees", "soroban.host",
             "soroban.scvm", "soroban.sac", "soroban.ops", "soroban",
             "soroban.wasm", "soroban.wasm.module", "soroban.wasm.decode",
             "soroban.wasm.validate", "soroban.wasm.interp",
             "soroban.wasm_host", "soroban.env_abi", "soroban.env_contract",
             "soroban.scvm_wasm", "tx", "herder.tx_set", "invariant",
             "main", "main.persistent_state", "db", "db.database",
             "db.libpq", "db.postgres", "db.pg_stub", "ledger",
             "bucket", "bucket.bucket", "bucket.bucket_index",
             "bucket.bucket_list", "bucket.hot_archive", "bucket.manager",
             "history", "history.archive", "herder.upgrades",
             "ledger.completion", "ledger.parallel_apply",
             "ledger.ledger_manager", "process", "process.process_manager",
             "work", "work.basic_work", "work.work", "history.manager",
             "catchup", "catchup.catchup_work", "catchup.apply_buckets",
             "catchup.pipeline", "catchup.manager"):
    __import__("stellar_core_tpu_torch." + name)
from stellar_core_tpu_torch.soroban import host, wasm_host
assert host.VM_REGISTRY[wasm_host.WASM_MAGIC] is wasm_host.run_wasm
from stellar_core_tpu_torch.xdr import schema
assert len(schema.identity()["curr"]) == 64
import chip_smoke
out = chip_smoke.txset_run(chip_smoke.txset_workload(8))
assert out["verdict"] is False and len(out["dropped"]) == 2, out
assert all(out["applied_ok"]) and len(out["results"]) == 6
out = chip_smoke.txset_run(chip_smoke.classic_workload(40))
assert out["verdict"] is False and len(out["dropped"]) == 1, out
assert all(out["applied_ok"]) and out["offers"] == 16, out
native = chip_smoke.NativeBatchVerifier()
out = chip_smoke.txset_run(chip_smoke.soroban_workload(8), native,
                           apply_batch=native, invariants=True)
assert len(out["dropped"]) == 1 and out["apply_cache"][1] == 0, out
out = chip_smoke.txset_run(chip_smoke.wasm_workload(8), native,
                           apply_batch=native, invariants=True)
assert len(out["dropped"]) == 1 and out["apply_cache"] == (4, 2), out
assert len(wasm_host._MODULE_CACHE) == 3
import shutil, tempfile
work = tempfile.mkdtemp()
wl = chip_smoke.close_workload(accounts=8, txs=4, ledgers=1)
run = chip_smoke.close_run(wl, work)
assert [led["tag"] for led in run["ledgers"]] == \
    ["upgrade", "create", "measured", "control"], run["ledgers"]
assert chip_smoke.close_reload(work, wl["passphrase"])[:2] == \
    (True, run["lcl"])
shutil.rmtree(work)
work = tempfile.mkdtemp()
wl = chip_smoke.catchup_workload(accounts=8, txs=4, ledgers=0, quiet=61,
                                 quiet_txs=2)
pub = chip_smoke.catchup_publish(wl, work)
assert pub["published"] == 1 and pub["has"].current_ledger == 63
run = chip_smoke.catchup_run(pub["root"], wl["passphrase"], work + "/node",
                             True, 0,
                             lambda app: chip_smoke.NativeBatchVerifier())
assert chip_smoke.catchup_problems(run, wl, pub, 63) == []
shutil.rmtree(work)
new = set(sys.modules) - before
bad = sorted(m for m in new if m in ("jax", "jaxlib", "stellar_core_tpu")
             or m.startswith(("jax.", "jaxlib.", "stellar_core_tpu.")))
print("BAD", bad)
"""


def test_port_imports_no_jax_subprocess():
    """tests/conftest.py imports JAX into this process, so a fresh
    interpreter runs the port on the CPU and lists what it imported."""
    res = subprocess.run([sys.executable, "-c", _GUARD.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "BAD []", res.stdout


def _forbidden(name):
    return name in ("jax", "jaxlib", "stellar_core_tpu") or \
        name.startswith(("jax.", "jaxlib.", "stellar_core_tpu."))


def test_port_sources_import_no_jax_static():
    files = sorted((ROOT / "stellar_core_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 25
    assert ROOT / "stellar_core_tpu_torch" / "native" / "loader.py" in files
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    getattr(node.func, "attr", getattr(node.func, "id", "")) \
                    in ("__import__", "import_module"):
                names = [str(node.args[0].value)]
            for name in names:
                assert not _forbidden(name), f"{path}: imports {name}"
