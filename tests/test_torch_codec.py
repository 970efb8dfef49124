"""The port's native XDR codec (xdr/native_codec.py over
native/src/pyext/xdr_codec.cpp, hooked into xdr/runtime.py) against the
port's Python path and the JAX package.

- tests/test_native_xdr.py runs twice: as written, and rebound to the
  port (tests/torch_rebind.py). The codec must load here, where g++
  exists: the rebound run never skips.
- Seeded values of every Struct and Union of every XDR module pack to the
  same bytes through the port's codec, the port's Python path and the JAX
  package; both of the port's paths unpack and clone them back equal.
  A process started with SC_XDR_NATIVE=0 has no codec and gives the same
  bytes.
- The extension is built into native/build/ under a hashed name, two
  processes building it at once both load it, and a build that fails
  raises: no stale extension, and the Python path serves for good.
"""

import hashlib
import importlib
import inspect
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

import test_native_xdr as ref_native_xdr
from test_torch_xdr_leaves import XDR_MODULES, _types_of, gen
from torch_rebind import (JAX_ROOT, PORT_ROOT, port_function, port_name,
                          rebound, reference_cases, run_case)
from stellar_core_tpu_torch.xdr import native_codec, runtime

ROOT = Path(__file__).resolve().parents[1]
CASES = reference_cases(ref_native_xdr)


def test_codec_is_live_in_a_hashed_build():
    nc = runtime._nc()
    assert nc is not None and nc.ok
    path = nc.ext.__file__
    assert os.path.dirname(path) == native_codec._BUILD
    assert native_codec._BUILD.endswith(
        os.path.join("stellar_core_tpu_torch", "native", "build"))
    assert os.path.basename(path).startswith("_scxdr_")
    assert native_codec.build_ext() == path      # built once
    with open(ROOT / "stellar_core_tpu" / "native" / "src" / "pyext" /
              "xdr_codec.cpp", "rb") as f:
        assert Path(native_codec._SRC).read_bytes() == f.read()


def _port_globals():
    """test_native_xdr's globals rebound to the port, its list of corpus
    types too (the rebinding maps names, not the items of a list)."""
    g = rebound(ref_native_xdr)
    g["CORPUS_TYPES"] = [getattr(importlib.import_module(
        port_name(c.__module__)), c.__name__)
        for c in ref_native_xdr.CORPUS_TYPES]
    return g


@pytest.mark.parametrize("case", CASES)
def test_reference_codec_tests_pass_on_both(case, monkeypatch):
    """Each of test_native_xdr's tests on the JAX package, then on the
    port, where _nc() must be live so that nothing skips."""
    assert runtime._nc() is not None
    assert run_case(case, False, {"monkeypatch": monkeypatch}) is None
    _, _, name, _ = case
    fn = port_function(getattr(ref_native_xdr, name), _port_globals())
    with pytest.MonkeyPatch.context() as mp:
        kw = {"monkeypatch": mp} if "monkeypatch" in \
            inspect.signature(fn).parameters else {}
        assert fn(**kw) is None


def test_rebinding_reaches_the_port_codec():
    g = _port_globals()
    assert g["runtime"] is runtime
    assert g["_nc"]() is runtime._nc()
    assert all(c.__module__.startswith(PORT_ROOT + ".xdr.")
               for c in g["CORPUS_TYPES"])
    assert len(g["CORPUS_TYPES"]) == len(ref_native_xdr.CORPUS_TYPES) == 9
    assert len(CASES) == 8


def _py_pack(rt, v):
    w = rt.Writer()
    v._pack(w)
    return bytes(w.buf)


@pytest.mark.parametrize("module", XDR_MODULES)
def test_seeded_values_equal_through_codec_python_and_reference(module):
    """Every Struct and Union of the module, 4 seeds each: the port's
    codec packs the bytes the port's Python path and the JAX package
    pack; the codec's and the Python path's unpack give the value back;
    the codec's clone is equal, a new object, and packs alike."""
    nc = runtime._nc()
    j_rt = __import__(f"{JAX_ROOT}.xdr.runtime", fromlist=["x"])
    jt, pt = _types_of(JAX_ROOT, module), _types_of(PORT_ROOT, module)
    assert sorted(jt) == sorted(pt) and pt
    packed = 0
    for name in sorted(pt):
        cls = pt[name]
        for seed in range(4):
            try:
                v = gen(runtime, cls, random.Random(seed))
                py = _py_pack(runtime, v)
            except Exception as e:          # noqa: BLE001 — by kind
                with pytest.raises(type(e)):
                    gen(runtime, cls, random.Random(seed)).to_bytes()
                continue
            packed += 1
            assert nc.pack(nc.cap, cls._nidx, v) == py == v.to_bytes(), \
                (name, seed)
            assert gen(j_rt, jt[name], random.Random(seed)).to_bytes() \
                == py, (name, seed)
            back = nc.unpack(nc.cap, cls._nidx, py)
            assert back == cls._unpack(runtime.Reader(py)) == v
            c = nc.clone(nc.cap, cls._nidx, v)
            assert c == v and c is not v and _py_pack(runtime, c) == py
    assert packed >= 2 * len(pt)


_DIGEST = r"""
import hashlib, random, sys
sys.path.insert(0, {tests!r})
sys.path.insert(0, {root!r})
from stellar_core_tpu_torch.xdr import runtime
from test_torch_xdr_leaves import XDR_MODULES, _types_of, gen
h = hashlib.sha256()
for module in XDR_MODULES:
    types = _types_of("stellar_core_tpu_torch", module)
    for name in sorted(types):
        for seed in range(4):
            try:
                v = gen(runtime, types[name], random.Random(seed))
                b = v.to_bytes()
            except Exception as e:
                b = type(e).__name__.encode()
            else:
                assert type(v).from_bytes(b).to_bytes() == b
                assert v.clone().to_bytes() == b
            h.update(name.encode() + b)
print(runtime._nc() is not None, h.hexdigest())
"""


def _digest_in_process(env):
    res = subprocess.run(
        [sys.executable, "-c", _DIGEST.format(tests=str(ROOT / "tests"),
                                              root=str(ROOT))],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env=dict(os.environ, **env))
    assert res.returncode == 0, res.stderr
    live, digest = res.stdout.split()
    return live == "True", digest


def test_sc_xdr_native_0_gives_the_same_bytes():
    """The same draws over every XDR module in two fresh processes, one
    with the codec, one with SC_XDR_NATIVE=0: the bytes (and the errors)
    hash alike, and the second has no codec."""
    with_codec = _digest_in_process({})
    without = _digest_in_process({"SC_XDR_NATIVE": "0"})
    assert with_codec[0] and not without[0]
    assert with_codec[1] == without[1]


_BUILD_AT_ONCE = r"""
import sys, time
sys.path.insert(0, {root!r})
from stellar_core_tpu_torch.xdr import native_codec, runtime
native_codec._BUILD = {build!r}
while time.time() < {start!r}:
    time.sleep(0.01)
nc = runtime._nc()
print(nc is not None and nc.ok, native_codec.state().ext.__file__)
"""


def test_two_processes_building_at_once_both_load(tmp_path):
    import time
    code = _BUILD_AT_ONCE.format(root=str(ROOT), build=str(tmp_path),
                                 start=time.time() + 3.0)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    loaded = [out.split() for out, _ in outs]
    assert [ok for ok, _ in loaded] == ["True", "True"], outs
    assert loaded[0][1] == loaded[1][1]
    assert os.path.dirname(loaded[0][1]) == str(tmp_path)
    assert [f for f in os.listdir(tmp_path)] == \
        [os.path.basename(loaded[0][1])]            # no temporary left


def test_failed_build_raises_and_the_python_path_serves(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(native_codec, "_BUILD", str(tmp_path))
    monkeypatch.setattr(native_codec, "FLAGS",
                        native_codec.FLAGS + ["-fno-such-flag"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_codec.build_ext()
    assert os.listdir(tmp_path) == []
    codec = native_codec.NativeCodec()
    codec.refresh()
    assert codec._failed and not codec.ok
    monkeypatch.setattr(runtime, "_NC", [codec])
    assert runtime._nc() is None
    from stellar_core_tpu_torch.xdr.transaction import Memo, MemoType
    m = Memo(MemoType.MEMO_TEXT, b"python path")
    raw = m.to_bytes()
    assert Memo.from_bytes(raw) == m and m.clone() == m
    assert hashlib.sha256(raw).digest() == hashlib.sha256(
        _py_pack(runtime, m)).digest()


def test_info_reports_whether_the_codec_serves(monkeypatch):
    """A port Application's info carries xdr_native, which phase 17 of
    chip_smoke.py reads from every node process: true while the codec
    serves, false once the process has fallen back to the Python path."""
    from stellar_core_tpu_torch.main import Application, get_test_config
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
    app = Application.create(VirtualClock(ClockMode.VIRTUAL_TIME),
                             get_test_config())
    app.start()
    try:
        assert app.info()["xdr_native"] is True
        monkeypatch.setattr(runtime, "_NC", [False])
        assert app.info()["xdr_native"] is False
    finally:
        app.shutdown()
