"""The rest of the port's XDR layer and its crypto leaves against the JAX
package's, on the CPU, with exact bytes.

- The reference's own XDR tests (tests/test_xdr.py, tests/test_xdr_schema.py)
  run twice: as written, and with every name they import from the JAX
  package rebound to the port's module of the same path. Both runs must
  pass and encode the same values to the same bytes, in the same order.
- `schema.identity()` and every type's descriptor are equal for the curr
  and next builds.
- Seeded values of every XDR type (one generator, driven by the same seed
  over each package's own classes) encode to equal bytes, and each
  package decodes the other's bytes back to them: the Soroban types of
  xdr/contract.py and the peer messages of xdr/overlay.py among them.
- ROADMAP Queue 3 items 1 and 2 are pinned: a Soroban `_TxExt` (and an
  envelope carrying it) decodes and re-encodes equal, and
  `repr(PublicKey(bytes(32)))` is the StrKey in both.
- StrKey, SipHash-2-4 under fixed keys and record-marked XDR streams
  agree between the packages.
"""

import importlib
import io
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import test_xdr as ref_xdr
import test_xdr_schema as ref_schema
from torch_rebind import (JAX_ROOT, PORT_ROOT, jax_case, port_case,
                          port_import, rebound, reference_cases)

ROOT = Path(__file__).resolve().parents[1]


def _mod(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


J_RT, P_RT = _mod(JAX_ROOT, "xdr.runtime"), _mod(PORT_ROOT, "xdr.runtime")
J_SCHEMA, P_SCHEMA = _mod(JAX_ROOT, "xdr.schema"), _mod(PORT_ROOT,
                                                         "xdr.schema")
XDR_MODULES = ("types", "ledger_entries", "ledger", "transaction", "results",
               "scp", "overlay", "contract", "next_types")


# ------------------------------------------- the reference tests, rebound --

def _recording(rt, sink):
    """Patch `rt`'s Struct and Union so every top-level encode appends
    (type name, bytes) to `sink`; returns the undo."""
    saved = {cls: cls.to_bytes for cls in (rt.Struct, rt.Union)}

    def wrap(orig):
        def to_bytes(self):
            b = orig(self)
            sink.append((type(self).__name__, b))
            return b
        return to_bytes

    for cls, orig in saved.items():
        cls.to_bytes = wrap(orig)

    def undo():
        for cls, orig in saved.items():
            cls.to_bytes = orig
    return undo


# test_clone_is_deep_and_equal draws values from the JAX package's fuzzer
# (main/fuzzer.py, not in the port): the seeded generator below covers
# it. The schema file's cross-process test and its Application test run
# the JAX package by name in a subprocess or boot a node; the port's
# cross-process identity is tested below.
REFERENCE_CASES = reference_cases(ref_xdr, {"test_clone_is_deep_and_equal"}) \
    + reference_cases(ref_schema, {"test_identity_stable_across_processes",
                                   "test_info_reports_xdr_identity"})


@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_reference_xdr_tests_pass_on_both_with_equal_bytes(case):
    module, owner, name, kw = case
    runs = []
    for rt, make in ((J_RT, jax_case), (P_RT, port_case)):
        sink = []
        undo = _recording(rt, sink)
        try:
            make(module, owner, name)(**kw)
        finally:
            undo()
        runs.append(sink)
    assert runs[0] == runs[1]


def test_rebinding_reaches_the_port():
    """The rebound reference tests really run on the port's classes."""
    g = rebound(ref_xdr)
    assert g["TransactionEnvelope"] is \
        _mod(PORT_ROOT, "xdr.transaction").TransactionEnvelope
    assert g["XdrError"] is P_RT.XdrError
    assert g["Int32"] is P_RT.Int32
    assert rebound(ref_schema)["schema"] is P_SCHEMA
    assert port_import("stellar_core_tpu.xdr.runtime",
                        fromlist=("Bool",)).Bool is P_RT.Bool


# ----------------------------------------------------------------- schema --

def test_schema_identity_equal():
    assert P_SCHEMA.identity() == J_SCHEMA.identity()


@pytest.mark.parametrize("build", ["curr", "next"])
def test_every_type_describes_alike(build):
    jns = getattr(J_SCHEMA, f"{build}_namespace")()
    pns = getattr(P_SCHEMA, f"{build}_namespace")()
    assert sorted(pns) == sorted(jns)
    for name in jns:
        assert P_SCHEMA.describe_type(pns[name]) == \
            J_SCHEMA.describe_type(jns[name]), name


def test_port_identity_stable_across_processes():
    code = ("import sys; sys.path.insert(0, %r); "
            "from stellar_core_tpu_torch.xdr import schema; "
            "i = schema.identity(); print(i['curr'], i['next'])") % str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    ident = J_SCHEMA.identity()
    assert r.stdout.split() == [ident["curr"], ident["next"]]


# ------------------------------------------------------- seeded values --

def gen(rt, t, rng, depth=0, max_depth=8, max_elems=2):
    """A random value of XDR type `t` built from `rt`'s classes (the JAX
    package's main/fuzzer.py XdrGenerator, with union arms taken in
    discriminant order so both packages draw the same value)."""
    def g(x):
        return gen(rt, x, rng, depth + 1, max_depth, max_elems)
    if isinstance(t, rt.Lazy):
        t = t._get()
    if isinstance(t, rt._Composite):
        t = t.cls
    if depth > max_depth:
        return t.default() if hasattr(t, "default") else t()
    if isinstance(t, type) and issubclass(t, rt.Struct):
        return t(**{fn: g(ft) for fn, ft in t._FIELDS})
    if isinstance(t, type) and issubclass(t, rt.Union):
        disc = rng.choice(sorted(t._ARMS, key=int))
        arm = t._ARMS[disc]
        if arm is None or arm[1] is None:
            return t(disc)
        return t(disc, g(arm[1]))
    if isinstance(t, rt.EnumType):
        return rng.choice(list(t.enum_cls))
    if isinstance(t, rt.Optional):
        return None if rng.random() < 0.5 else g(t.elem)
    if isinstance(t, rt.Opaque):
        return bytes(rng.getrandbits(8) for _ in range(t.n))
    if isinstance(t, rt.VarOpaque):
        return bytes(rng.getrandbits(8)
                     for _ in range(rng.randint(0, min(t.max_len, 32))))
    if isinstance(t, rt.Array):
        return [g(t.elem) for _ in range(t.n)]
    if isinstance(t, rt.VarArray):
        return [g(t.elem)
                for _ in range(rng.randint(0, min(t.max_len, max_elems)))]
    if isinstance(t, rt._Bool):
        return rng.random() < 0.5
    if isinstance(t, (rt._Int32, rt._Int64)):
        if rng.random() < 0.1:
            bits = 31 if isinstance(t, rt._Int32) else 63
            return rng.randint(-2 ** bits, 2 ** bits - 1)
        return rng.randint(-100, 1000)
    if isinstance(t, (rt._Uint32, rt._Uint64)):
        if rng.random() < 0.1:
            return rng.randint(0, 2 ** (32 if isinstance(t, rt._Uint32)
                                        else 64) - 1)
        return rng.randint(0, 1000)
    raise TypeError(f"cannot generate {t!r}")


def _types_of(pkg, module):
    rt = _mod(pkg, "xdr.runtime")
    mod = _mod(pkg, f"xdr.{module}")
    return {n: c for n, c in vars(mod).items() if isinstance(c, type)
            and c.__module__ == mod.__name__
            and issubclass(c, (rt.Struct, rt.Union))}


def _draw(rt, t, seed, **kw):
    """The bytes of a seeded value of `t`, or the name of the error its
    draw or its encoding raised (a default-built union, a value past a
    bound)."""
    try:
        return gen(rt, t, random.Random(seed), **kw).to_bytes()
    except Exception as e:          # noqa: BLE001 — compared by kind
        return type(e).__name__


@pytest.mark.parametrize("module", XDR_MODULES)
def test_seeded_values_encode_alike(module):
    """Every Struct and Union of the module, 4 seeds each: the same draw
    in both packages encodes to the same bytes, and each decodes the
    other's bytes back to them."""
    jt, pt = _types_of(JAX_ROOT, module), _types_of(PORT_ROOT, module)
    assert sorted(jt) == sorted(pt) and jt
    encoded = 0
    for name in sorted(jt):
        for seed in range(4):
            jb = _draw(J_RT, jt[name], seed)
            pb = _draw(P_RT, pt[name], seed)
            assert jb == pb, (name, seed)
            if isinstance(jb, bytes):
                encoded += 1
                assert pt[name].from_bytes(jb).to_bytes() == jb
                assert jt[name].from_bytes(pb).to_bytes() == pb
    assert encoded >= 2 * len(jt)


SOROBAN_UNIONS = [("LedgerKey", "ledger_entries", range(6, 10)),
                  ("_LedgerEntryData", "ledger_entries", range(6, 10)),
                  ("_OperationBody", "transaction", range(24, 27)),
                  ("_OperationResultTr", "results", range(24, 27)),
                  ("_TxExt", "transaction", [1])]


@pytest.mark.parametrize("union,module,discs", SOROBAN_UNIONS,
                         ids=[u for u, _, _ in SOROBAN_UNIONS])
def test_soroban_arms_join_the_core_unions(union, module, discs):
    """The arms xdr/contract.py registers when the xdr package loads: the
    same arms, and seeded values of each encode alike both ways."""
    ju = getattr(_mod(JAX_ROOT, f"xdr.{module}"), union)
    pu = getattr(_mod(PORT_ROOT, f"xdr.{module}"), union)
    for disc in discs:
        assert disc in pu._ARMS and pu._ARMS[disc][0] == ju._ARMS[disc][0]
        for seed in range(6):
            jv = ju(disc, gen(J_RT, ju._ARMS[disc][1], random.Random(seed)))
            pv = pu(disc, gen(P_RT, pu._ARMS[disc][1], random.Random(seed)))
            assert jv.to_bytes() == pv.to_bytes()
            assert pu.from_bytes(jv.to_bytes()).to_bytes() == jv.to_bytes()


@pytest.mark.parametrize("name", ["SCVal", "SorobanTransactionData",
                                  "ContractDataEntry", "ConfigSettingEntry",
                                  "InvokeHostFunctionOp"])
def test_contract_corpus_encodes_alike(name):
    jc = getattr(_mod(JAX_ROOT, "xdr.contract"), name)
    pc = getattr(_mod(PORT_ROOT, "xdr.contract"), name)
    for seed in range(40):
        jb = gen(J_RT, jc, random.Random(seed), max_depth=10).to_bytes()
        assert gen(P_RT, pc, random.Random(seed),
                   max_depth=10).to_bytes() == jb
        assert pc.from_bytes(jb).to_bytes() == jb


def _draw_arm(rt, union, disc, seed, **kw):
    """Like _draw, for a value of `union` on the arm `disc`."""
    arm = union._ARMS[disc]
    try:
        v = union(disc) if arm is None or arm[1] is None else \
            union(disc, gen(rt, arm[1], random.Random(seed), **kw))
        return v.to_bytes()
    except Exception as e:          # noqa: BLE001 — compared by kind
        return type(e).__name__


def test_every_stellar_message_arm_encodes_alike():
    """Each arm of StellarMessage, 4 seeds, equal bytes or the same
    error; every arm encodes at least once, and the port decodes the
    JAX package's AuthenticatedMessage around it."""
    jm = _mod(JAX_ROOT, "xdr.overlay")
    pm = _mod(PORT_ROOT, "xdr.overlay")
    mac = _mod(JAX_ROOT, "xdr.types").HmacSha256Mac(mac=b"\x07" * 32)
    assert sorted(pm.StellarMessage._ARMS) == sorted(jm.StellarMessage._ARMS)
    for disc in jm.StellarMessage._ARMS:
        encoded = 0
        for seed in range(4):
            jb = _draw_arm(J_RT, jm.StellarMessage, disc, seed, max_depth=14)
            assert _draw_arm(P_RT, pm.StellarMessage, disc, seed,
                             max_depth=14) == jb, (disc, seed)
            if isinstance(jb, bytes):
                encoded += 1
                am = jm.AuthenticatedMessage(0, jm._AuthenticatedMessageV0(
                    sequence=seed, message=jm.StellarMessage.from_bytes(jb),
                    mac=mac)).to_bytes()
                assert pm.AuthenticatedMessage.from_bytes(am).to_bytes() \
                    == am
        assert encoded, disc


# ------------------------------------------------- ROADMAP Queue 3 pins --

SOROBAN_TX_EXT = ("000000010000000000000000000000000000000100000001000000"
                  "010000000000000001")


def test_soroban_tx_ext_decodes_alike():
    """Queue 3 item 1: this `_TxExt` raised XdrError in the port."""
    data = bytes.fromhex(SOROBAN_TX_EXT)
    jv = _mod(JAX_ROOT, "xdr.transaction")._TxExt.from_bytes(data)
    pv = _mod(PORT_ROOT, "xdr.transaction")._TxExt.from_bytes(data)
    assert pv.disc == jv.disc == 1
    assert type(pv.value).__name__ == "SorobanTransactionData"
    assert pv.to_bytes() == jv.to_bytes() == data


def test_envelope_with_soroban_ext_decodes_alike():
    from test_torch_xdr import env_plain
    jt = _mod(JAX_ROOT, "xdr.transaction")
    env = env_plain()
    env.value.tx.ext = jt._TxExt.from_bytes(bytes.fromhex(SOROBAN_TX_EXT))
    data = env.to_bytes()
    assert bytes.fromhex(SOROBAN_TX_EXT) in data
    penv = _mod(PORT_ROOT, "xdr.transaction").TransactionEnvelope \
        .from_bytes(data)
    assert penv.to_bytes() == data
    assert penv.value.tx.ext.value.resourceFee == 1


def test_public_key_repr_is_strkey_in_both():
    """Queue 3 item 2: the port printed hex."""
    jk, pk = _mod(JAX_ROOT, "crypto.keys"), _mod(PORT_ROOT, "crypto.keys")
    want = "PublicKey(GAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAWHF)"
    assert repr(pk.PublicKey(bytes(32))) == repr(jk.PublicKey(bytes(32))) \
        == want
    raw = np.random.default_rng(4).bytes(32)
    assert repr(pk.PublicKey(raw)) == repr(jk.PublicKey(raw))


# ------------------------------------------------------- crypto leaves --

JSK, PSK = _mod(JAX_ROOT, "crypto.strkey"), _mod(PORT_ROOT, "crypto.strkey")


def test_strkey_encode_decode_equal():
    rng = np.random.default_rng(21)
    for _ in range(50):
        raw, mux = rng.bytes(32), int(rng.integers(0, 2 ** 63))
        for enc, dec in (("encode_ed25519_public", "decode_ed25519_public"),
                         ("encode_ed25519_seed", "decode_ed25519_seed")):
            s = getattr(PSK.StrKey, enc)(raw)
            assert s == getattr(JSK.StrKey, enc)(raw)
            assert getattr(PSK.StrKey, dec)(s) == raw == \
                getattr(JSK.StrKey, dec)(s)
        assert PSK.StrKey.encode_contract(raw) == \
            JSK.StrKey.encode_contract(raw)
        s = PSK.StrKey.encode_muxed_account(raw, mux)
        assert s == JSK.StrKey.encode_muxed_account(raw, mux)
        assert PSK.StrKey.decode_muxed_account(s) == (raw, mux) == \
            JSK.StrKey.decode_muxed_account(s)
        for ver in (PSK.VER_PRE_AUTH_TX, PSK.VER_HASH_X,
                    PSK.VER_SIGNED_PAYLOAD):
            payload = rng.bytes(int(rng.integers(1, 100)))
            assert PSK.StrKey.encode(ver, payload) == \
                JSK.StrKey.encode(ver, payload)
        assert PSK.crc16_xmodem(raw) == JSK.crc16_xmodem(raw)


def _strkey_outcome(mod, fn, s):
    try:
        return ("ok", getattr(mod.StrKey, fn)(s))
    except Exception as e:          # noqa: BLE001 — compared by kind
        assert isinstance(e, ValueError)
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("fn", ["decode_ed25519_public",
                                "decode_ed25519_seed",
                                "decode_muxed_account"])
def test_strkey_bad_inputs_fail_alike(fn):
    """Flipped characters (bad checksums), wrong version bytes, bad
    lengths, non-canonical tails and garbage: the same outcome, the same
    error class (StrKeyError, a ValueError) and message."""
    rng = np.random.default_rng(22)
    alphabet = "ABCDEFGHIJKLMNOPQRSTUVWXYZ234567"
    good = [JSK.StrKey.encode_ed25519_public(rng.bytes(32)),
            JSK.StrKey.encode_ed25519_seed(rng.bytes(32)),
            JSK.StrKey.encode_muxed_account(rng.bytes(32), 7),
            JSK.StrKey.encode(JSK.VER_PUBKEY_ED25519, rng.bytes(31))]
    inputs = list(good) + ["", "G", "GAAA", "not base32!", "0" * 56]
    for s in good:
        for _ in range(20):
            i = int(rng.integers(len(s)))
            inputs.append(s[:i] + alphabet[int(rng.integers(32))] + s[i + 1:])
        inputs += [s[:-1], s + "A", s.lower()]
    errors = 0
    for s in inputs:
        j = _strkey_outcome(JSK, fn, s)
        assert _strkey_outcome(PSK, fn, s) == j, s
        errors += j[0] == "error"
    assert errors > len(inputs) // 2


def test_siphash24_equal_under_fixed_keys():
    jsh = _mod(JAX_ROOT, "crypto.shorthash")
    psh = _mod(PORT_ROOT, "crypto.shorthash")
    rng = np.random.default_rng(23)
    # the reference vector of the SipHash paper (key 00..0f, 15 bytes)
    key, msg = bytes(range(16)), bytes(range(15))
    assert psh.siphash24(key, msg) == jsh.siphash24(key, msg) == \
        0xa129ca6149be45e5
    for n in range(70):
        key, data = rng.bytes(16), rng.bytes(n)
        assert psh.siphash24(key, data) == jsh.siphash24(key, data)
    saved = (jsh._seed, psh._seed)
    try:
        for pkg in (jsh, psh):
            pkg.seed_for_testing(b"\x09" * 16)
        assert psh.compute_hash(b"bucket") == jsh.compute_hash(b"bucket")
    finally:
        jsh._seed, psh._seed = saved


def test_xdr_stream_reads_what_the_other_wrote():
    jxs = _mod(JAX_ROOT, "util.xdr_stream")
    pxs = _mod(PORT_ROOT, "util.xdr_stream")
    jle = _mod(JAX_ROOT, "xdr.ledger_entries").LedgerEntry
    ple = _mod(PORT_ROOT, "xdr.ledger_entries").LedgerEntry
    entries = [gen(J_RT, jle, random.Random(s)) for s in range(12)]
    for writer, reader, cls in ((jxs, pxs, ple), (pxs, jxs, jle)):
        f = io.BytesIO()
        for e in entries:
            writer.write_record(f, e.to_bytes())
        f.seek(0)
        assert [e.to_bytes() for e in reader.read_all(f, cls)] == \
            [e.to_bytes() for e in entries]
    data = f.getvalue()
    for bad in (data[:-1], data[:2], b"\x00\x00\x00\x04abcd"):
        outs = []
        for pkg in (jxs, pxs):
            try:
                list(pkg.read_all(io.BytesIO(bad), ple))
                outs.append("ok")
            except OSError as e:
                outs.append(str(e))
        assert outs[0] == outs[1] != "ok"
