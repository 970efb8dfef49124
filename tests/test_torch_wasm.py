"""The port's wasm VM (soroban/wasm/, wasm_host.py, env_abi.py,
env_contract.py, scvm_wasm.py) against the JAX package's, on the CPU.

- The JAX package's tests/test_wasm_vm.py runs twice: as written, and
  with its names rebound to the port's modules (tests/torch_rebind.py).
  Every `Instance.invoke` of both runs is recorded (export, arguments,
  results or trap, the instructions charged to the meter, memory,
  globals) and the two records must be equal.
- tests/test_env_abi.py's tests that need no node run the same way: the
  Val encoding, symbols, the SCVal bridge, module detection, and the
  host-function table tests over a live SorobanHost on a ledger with the
  initial Soroban settings (built with the JAX package, carried into the
  port as bytes). Every host-function call's arguments and result or
  error must be equal. The SDK-built binaries' test skips, as the JAX
  package's does, where the reference tree is absent.
- Seeded modules, built with numpy from a seed with the JAX package's
  ModuleBuilder, run through both interpreters under a fuel meter: equal
  results, traps, fuel, memory and globals; then each again with the
  least fuel that gives its result (the same in both) and one
  instruction less (a fuel trap in both).
- chip_smoke.py phase 12's mix at 40 transactions through both
  packages' txset path with every default invariant on, the port's on
  the plain kernels.
"""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
import test_env_abi as ref_env_abi
import test_wasm_vm as ref_wasm_vm
from torch_rebind import jax_case, port_case, rebound, reference_cases
from torch_tx_parity import (J, P, NETWORK_ID, OracleVerifier, clear_caches,
                             jax_root_from_xdr, port_root, run_set, state_of)
from txtest_utils import TestLedger

M64 = (1 << 64) - 1


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_caches()
    yield
    clear_caches()


# ------------------------------------------- the reference tests, rebound --

def _recording_invoke(interp, sink):
    """Patch `interp.Instance.invoke` to append each call's export,
    arguments, outcome, the instructions flushed to the meter, a digest
    of memory and the globals to `sink`; returns the undo."""
    orig = interp.Instance.invoke

    def invoke(self, name, args):
        meter, charged = self.meter, []

        class Counting:
            def flush(self_, executed):
                charged.append(executed)
                return meter.flush(executed)

        self.meter = Counting()
        try:
            out = orig(self, name, args)
            outcome = ("ok", list(out))
            return out
        except Exception as e:
            outcome = (type(e).__name__, getattr(e, "kind", None), str(e))
            raise
        finally:
            self.meter = meter
            sink.append((name, list(args), outcome, sum(charged),
                         hashlib.sha256(bytes(self.memory)).hexdigest(),
                         list(self.globals)))

    interp.Instance.invoke = invoke
    return lambda: setattr(interp.Instance, "invoke", orig)


@pytest.mark.parametrize("case", reference_cases(ref_wasm_vm))
def test_reference_wasm_vm_tests_on_both_with_equal_runs(case):
    module, owner, name, kw = case
    runs = []
    for pkg, make in ((J, jax_case), (P, port_case)):
        sink = []
        undo = _recording_invoke(pkg.wasm.interp, sink)
        try:
            make(module, owner, name)(**kw)
        finally:
            undo()
        runs.append(sink)
    assert runs[0] == runs[1]


def test_rebinding_reaches_the_port_vm():
    g = rebound(ref_wasm_vm)
    assert g["Instance"] is P.wasm.Instance
    assert g["WasmTrap"] is P.wasm.WasmTrap
    assert g["encode_module"] is P.wasm.module.encode_module
    assert rebound(ref_env_abi)["env_abi"] is P.env_abi


def _stand_in_app(pkg):
    """What the table tests read of an Application: a root with the
    initial Soroban settings (the JAX package's, or the port's copy of
    its bytes), its header and the network id."""
    led = TestLedger()
    with J.ledger_txn.LedgerTxn(led.root) as ltx:
        J.network_config.create_initial_settings(ltx)
        ltx.commit()
    root = led.root if pkg is J else port_root(led.root)
    return SimpleNamespace(
        ledger_manager=SimpleNamespace(
            root=root, get_last_closed_ledger_header=root.get_header),
        config=SimpleNamespace(network_id=lambda: NETWORK_ID))


def _recording_table(env_abi, sink):
    """Patch `env_abi.env_host_table` so each host function of the tables
    it builds appends (module, name, arguments, result or error) to
    `sink`; returns the undo."""
    orig = env_abi.env_host_table

    def recorded(key, fn):
        def call(inst, *args):
            try:
                res = fn(inst, *args)
            except Exception as e:
                sink.append((key, args, type(e).__name__, str(e)))
                raise
            sink.append((key, args, res))
            return res
        return call

    def table(ectx, charge):
        out = orig(ectx, charge)
        for key, hf in out.items():
            hf.fn = recorded(key, hf.fn)
        return out

    env_abi.env_host_table = table
    return lambda: setattr(env_abi, "env_host_table", orig)


ENV_ABI_TESTS = ("test_val_encoding_ground_truth", "test_symbol_roundtrip",
                 "test_scval_val_bridge_roundtrip",
                 "test_env_abi_module_detection", "test_map_module_semantics",
                 "test_vec_and_bytes_extensions",
                 "test_i128_string_timepoint_objects",
                 "test_prng_deterministic_and_log",
                 "test_ledger_context_and_ttl",
                 "test_verify_sig_ed25519_host_fn",
                 "test_u256_i256_env_family")


@pytest.mark.parametrize("name", ENV_ABI_TESTS)
def test_reference_env_abi_tests_on_both_with_equal_calls(name):
    """The table-level tests call host functions straight from
    `env_host_table`; the app they need is `_stand_in_app`."""
    runs = []
    for pkg, make in ((J, jax_case), (P, port_case)):
        sink = []
        undo = _recording_table(pkg.env_abi, sink)
        try:
            fn = make(ref_env_abi, None, name)
            if "app" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
                fn(app=_stand_in_app(pkg))
            else:
                fn()
        finally:
            undo()
        runs.append(sink)
    assert runs[0] == runs[1]
    assert runs[1] or name in ENV_ABI_TESTS[:4]


@ref_env_abi.needs_reference
def test_reference_sdk_contract_runs_on_the_port():
    """The reference's SDK-built example_add_i32.wasm on the port's VM
    (tests/test_env_abi.py's direct test, rebound)."""
    port_case(ref_env_abi, None,
              "test_reference_sdk_contract_add_i32_direct")()


# ------------------------------------------------- seeded differential --

EDGES = (0, 1, 2, 7, 63, 64, M64, 1 << 63, (1 << 63) - 1, 0xFFFFFFFF,
         1 << 32)
UNARY = (0x79, 0x7A, 0x7B, 0xC2, 0xC3, 0xC4)     # clz ctz popcnt extends
BINARY = tuple(range(0x7C, 0x8B))                # i64 add .. rotr
COMPARE = tuple(range(0x51, 0x5B))               # i64 eq .. ge_u


def random_module(rng):
    """A seeded module, built with the JAX package's ModuleBuilder:
    f(x, y) -> i64 runs 3-8 random statements (local and global sets,
    stores, memory.fill/copy/init/grow, if/else, counted loops nested up
    to twice), then returns a random expression (i64 arithmetic,
    comparisons, select, loads, a host import, call_indirect through a
    table whose third slot is empty). Divisors, addresses and bulk
    lengths mostly stay in range, so most runs finish and some trap
    (div0, oob, indirect, call depth). Returns (bytes, arguments)."""
    W = J.wasm
    mod = W.module
    loads = (mod.I64_LOAD, mod.I64_LOAD8_S, mod.I64_LOAD16_U,
             mod.I64_LOAD32_S)
    stores = (mod.I64_STORE, mod.I64_STORE8, mod.I64_STORE16,
              mod.I64_STORE32)
    I64 = W.I64
    b = W.ModuleBuilder()
    host = b.import_func("env", "mix", [I64], [I64])
    b.add_memory(1, 2)
    seg_len = int(rng.integers(1, 40))
    seg = b.add_passive_data(rng.bytes(seg_len))
    glob = b.add_global(I64, True, int(rng.integers(0, 1 << 63)))
    sig = b.functype([I64, I64], [I64])

    def const():
        return EDGES[int(rng.integers(len(EDGES)))] if rng.random() < .3 \
            else int(rng.integers(0, 1 << 63)) * 2 + int(rng.integers(2))

    def addr(f, bound=0xFFF8):
        expr(f, 1)
        f.op(0xA7)                                   # i32.wrap_i64
        if rng.random() < .97:
            f.i32_const(bound).op(0x71)              # i32.and

    def expr(f, depth, calls=True):
        pick = int(rng.integers(10 if depth > 0 else 3))
        if pick == 0:
            f.local_get(int(rng.integers(3)))
        elif pick == 1:
            f.i64_const(const())
        elif pick == 2:
            f.global_get(glob)
        elif pick == 3:
            expr(f, depth - 1, calls)
            f.op(UNARY[int(rng.integers(len(UNARY)))])
        elif pick in (4, 5):
            op = BINARY[int(rng.integers(len(BINARY)))]
            expr(f, depth - 1, calls)
            expr(f, depth - 1, calls)
            if 0x7F <= op <= 0x82 and rng.random() < .95:
                f.i64_const(1).op(0x84)              # a divisor not 0
            f.op(op)
        elif pick == 6:
            expr(f, depth - 1, calls)
            expr(f, depth - 1, calls)
            f.op(COMPARE[int(rng.integers(len(COMPARE)))]).op(0xAD)
        elif pick == 7:
            expr(f, depth - 1, calls)
            expr(f, depth - 1, calls)
            expr(f, depth - 1, calls)
            f.op(0xA7).select()
        elif pick == 8:
            addr(f)
            f.load(loads[int(rng.integers(len(loads)))])
        elif calls and rng.random() < .5:
            expr(f, depth - 1, calls)
            expr(f, depth - 1, calls)
            f.i32_const(int(rng.random() < .05) + 1 if rng.random() < .5
                        else 0).call_indirect(sig)
        elif calls:
            expr(f, depth - 1, calls)
            f.call(host)
        else:
            f.memory_size().op(0xAD)

    helpers = []
    for _ in range(2):
        fidx, h = b.add_func([I64, I64], [I64], locals_=[I64])
        expr(h, 2, calls=False)
        helpers.append(fidx)
    fidx, f = b.add_func([I64, I64], [I64], locals_=[I64, I64, I64])

    def statements(depth, count):
        for _ in range(count):
            pick = int(rng.integers(8 if depth < 2 else 5))
            if pick == 0:
                expr(f, 3)
                f.local_set(2)
            elif pick == 1:
                addr(f)
                expr(f, 2)
                f.store(stores[int(rng.integers(len(stores)))])
            elif pick == 2:
                expr(f, 2)
                f.global_set(glob)
            elif pick == 3:
                bulk = int(rng.integers(4))
                if bulk == 0:
                    addr(f, 0x7FFF)
                    f.i32_const(int(rng.integers(256)))
                    f.i32_const(int(rng.integers(400))).memory_fill()
                elif bulk == 1:
                    addr(f, 0x7FFF)
                    addr(f, 0x7FFF)
                    f.i32_const(int(rng.integers(400))).memory_copy()
                elif bulk == 2:
                    addr(f, 0x7FFF)
                    src = int(rng.integers(seg_len))
                    f.i32_const(src).i32_const(int(rng.integers(
                        seg_len - src + 1 + (rng.random() < .05))))
                    f.memory_init(seg)
                else:
                    f.i32_const(1).memory_grow().drop()
            elif pick == 4:
                expr(f, 2)
                f.drop()
            elif pick in (5, 6):
                expr(f, 2)
                f.op(0xA7).if_()
                statements(depth + 1, int(rng.integers(1, 4)))
                if rng.random() < .5:
                    f.else_()
                    statements(depth + 1, int(rng.integers(1, 4)))
                f.end()
            else:
                counter = 3 + depth
                f.i64_const(int(rng.integers(0, 12))).local_set(counter)
                f.block().loop()
                f.local_get(counter).op(0x50).br_if(1)   # i64.eqz
                statements(depth + 1, int(rng.integers(1, 4)))
                f.local_get(counter).i64_const(1).op(0x7D)
                f.local_set(counter).br(0).end().end()

    statements(0, int(rng.integers(3, 9)))
    expr(f, 3)
    b.add_table(3)
    b.add_element(0, helpers)
    b.export_func("f", fidx)
    return b.encode(), [const(), const()]


class Fuel:
    """A meter with a hard cap of `cap` instructions."""

    def __init__(self, cap):
        self.cap, self.used = cap, 0

    def flush(self, executed):
        self.used += executed
        return max(0, self.cap - self.used)


def run_module(pkg, code, args, cap):
    """Decode, validate, instantiate and invoke f in `pkg` under a
    `Fuel(cap)` meter: (outcome, fuel used, memory digest, globals)."""
    W = pkg.wasm
    m = W.decode_module(code)
    W.validate_module(m)
    meter = Fuel(cap)
    imports = {("env", "mix"): W.HostFunc(
        [W.I64], [W.I64], lambda inst, v: (v * 0x9E3779B97F4A7C15 + 1) & M64)}
    inst = W.Instance(m, imports=imports, meter=meter)
    try:
        outcome = ("ok", inst.invoke("f", list(args)))
    except W.WasmTrap as t:
        outcome = ("trap", t.kind)
    return (outcome, meter.used, hashlib.sha256(bytes(inst.memory)).digest(),
            list(inst.globals))


CAP = 1 << 20


SEEDS = range(48)


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_modules_agree_with_fuel_exact(seed):
    code, args = random_module(np.random.default_rng(seed))
    assert P.wasm.module.encode_module(P.wasm.decode_module(code)) == code
    full = run_module(J, code, args, CAP)
    assert run_module(P, code, args, CAP) == full
    assert full[0] != ("trap", "fuel")
    lo, hi = -1, full[1]          # the least cap that gives this outcome
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if run_module(J, code, args, mid) == full \
            else (mid, hi)
    assert run_module(P, code, args, hi) == full
    if hi:
        short = run_module(J, code, args, hi - 1)
        assert short[0] == ("trap", "fuel")
        assert run_module(P, code, args, hi - 1) == short


def test_seeded_modules_cover_results_and_traps():
    """The seeds above end in a result and in each kind of trap."""
    kinds = set()
    for seed in SEEDS:
        code, args = random_module(np.random.default_rng(seed))
        status, value = run_module(P, code, args, CAP)[0]
        kinds.add(value if status == "trap" else status)
    assert kinds == {"ok", "oob", "div0", "stack"}, kinds


# --------------------------------------------------- phase 12 at n = 40 --

def test_phase12_mix_matches_jax_with_invariants():
    """chip_smoke.py phase 12's workload at 40 transactions through both
    packages' txset path with every default invariant enabled: validation
    through the herder's prevalidator, then catchup's apply-time batch
    written through to the verify cache, on the port's plain kernels
    (CudaBatchVerifier on the CPU) and on the oracle for the JAX package.
    Equal sets, verdicts, trim, batches, results, events, return values
    and ledgers; the host's auth verifies are cache hits and its
    contract-level verifies (sig_ok, sig_bad) the only misses; the
    module cache holds the three contracts."""
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
    wl = chip_smoke.wasm_workload(40)
    nid = wl["network_id"]
    jroot = jax_root_from_xdr(wl["header"], wl["entries"])
    proot = P.ledger_txn.InMemoryLedgerTxnRoot.from_xdr(wl["header"],
                                                        wl["entries"])
    assert state_of(jroot) == state_of(proot)
    oracle = OracleVerifier()
    jout = run_set(J, jroot, wl["envelopes"], oracle, nid,
                   apply_batch=oracle, invariants=True, events=True)
    card = chip_smoke.RecordingVerifier(CudaBatchVerifier(device="cpu"))
    pout = run_set(P, proot, wl["envelopes"], card, nid, apply_batch=card,
                   invariants=True, events=True)
    assert pout == jout
    kinds = {k: wl["kinds"].count(k) for k in set(wl["kinds"])}
    assert kinds == {"env_auth": 32, "wasm_counter": 3, "sig_ok": 1,
                     "sig_bad": 1, "bad_auth": 1, "fuel": 1, "flipped": 1}
    auth = kinds["env_auth"] + kinds["bad_auth"] + kinds["fuel"]
    assert [len(c[0]) for c in card.calls] == [40, 39 + auth]
    assert [c[1].count(False) for c in card.calls] == [1, 1]
    assert pout["apply_cache"] == (auth, kinds["sig_ok"] + kinds["sig_bad"])
    outcomes, unpaid = chip_smoke.soroban_outcomes(
        {"root": proot, "order": pout["order"], "results": pout["results"]},
        wl)
    assert outcomes == chip_smoke.wasm_expected_outcomes(wl["kinds"])
    assert not unpaid and len(pout["dropped"]) == 1
    assert sorted(P.wasm_host._MODULE_CACHE) == sorted(wl["codes"])
    count = proot._lookup(wl["count_key"]).data.value.val
    assert count.value == kinds["wasm_counter"]
    bumped = sum(bool(ev) for ev, _ in pout["events"])
    assert bumped == kinds["env_auth"]
