"""Compile the declarative XDR type world into the _scxdr C codec.

The runtime (xdr/runtime.py) stays the semantic oracle; this module
walks every registered Struct/Union class, flattens the type graph into
a node program, and hands it to the C extension
(native/src/pyext/xdr_codec.cpp).  runtime.py dispatches
to_bytes/from_bytes/clone through here when the extension is available,
falling back to the Python path on any error so messages and edge-case
behavior are unchanged (reference equivalent: xdrpp's generated C++
codecs, src/Makefile.am:46-51).

Disable with SC_XDR_NATIVE=0 (tests exercise both paths).

The extension is built at first use into native/build/ by the native
loader's build_hashed: under a name hashed from the source, the flags
and the Python ABI, through a temporary file and a rename, so processes
that build at once each load a whole library and a changed source never
loads a stale one.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import sysconfig
import threading

# node kind codes — must match enum Kind in xdr_codec.cpp
K_I32, K_U32, K_I64, K_U64, K_BOOL = 0, 1, 2, 3, 4
K_OPAQUE, K_VAROPAQUE, K_ARRAY, K_VARARRAY, K_OPT = 5, 6, 7, 8, 9
K_ENUM, K_STRUCT, K_UNION = 10, 11, 12

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "src", "pyext", "xdr_codec.cpp")
_BUILD = os.path.join(_PKG, "native", "build")
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden"]


def build_ext() -> str:
    """The extension's path, compiled unless this source, these flags
    and this Python ABI are built. Raises with the compiler output when
    g++ fails; there is no stale fallback."""
    from ..native.loader import build_hashed
    inc = sysconfig.get_paths()["include"]
    abi = sysconfig.get_config_var("EXT_SUFFIX") or \
        sys.implementation.cache_tag
    return build_hashed(
        _BUILD, "_scxdr", FLAGS + [abi], [_SRC],
        lambda out: ["g++"] + FLAGS + [f"-I{inc}", "-o", out, _SRC])


def _load_ext():
    spec = importlib.util.spec_from_file_location("_scxdr", build_ext())
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class NativeCodec:
    """Holds the loaded extension + the compiled program for the current
    schema generation.  runtime._nc() refreshes on generation bumps
    (class creation, register_arm)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.ext = None
        self.cap = None
        self.gen = -1
        self.ok = False
        self.pack = None
        self.unpack = None
        self.clone = None
        self._failed = False

    def refresh(self) -> None:
        from . import runtime
        with self._lock:
            if self.gen == runtime._XDR_GEN[0]:
                return
            if self._failed:
                self.gen = runtime._XDR_GEN[0]
                return
            try:
                if self.ext is None:
                    self.ext = _load_ext()
                self.cap = self._compile(runtime)
                self.pack = self.ext.pack
                self.unpack = self.ext.unpack
                self.clone = self.ext.clone
                self.gen = runtime._XDR_GEN[0]
                self.ok = True
            except Exception:
                # no native toolchain / build failure: permanent Python
                # fallback for this process
                self._failed = True
                self.ok = False
                self.gen = runtime._XDR_GEN[0]

    def _compile(self, runtime):
        nodes: list = []
        memo_t: dict = {}
        memo_c: dict = {}
        keep: list = []   # keep XdrType instances alive for id() keys

        def t_idx(t) -> int:
            while isinstance(t, runtime.Lazy):
                t = t._get()
            if isinstance(t, runtime._Composite):
                return c_idx(t.cls)
            k = id(t)
            got = memo_t.get(k)
            if got is not None:
                return got
            keep.append(t)
            if isinstance(t, runtime._Int32):
                node = (K_I32,)
            elif isinstance(t, runtime._Uint32):
                node = (K_U32,)
            elif isinstance(t, runtime._Int64):
                node = (K_I64,)
            elif isinstance(t, runtime._Uint64):
                node = (K_U64,)
            elif isinstance(t, runtime._Bool):
                node = (K_BOOL,)
            elif isinstance(t, runtime.Opaque):
                node = (K_OPAQUE, t.n)
            elif isinstance(t, runtime.VarOpaque):   # incl. XdrString
                node = (K_VAROPAQUE, t.max_len)
            elif isinstance(t, runtime.EnumType):
                vmap = {int(v): m
                        for v, m in t.enum_cls._value2member_map_.items()}
                node = (K_ENUM, t.enum_cls, vmap)
            elif isinstance(t, (runtime.Array, runtime.VarArray)):
                # reserve slot first: element may cycle back
                i = len(nodes)
                nodes.append(None)
                memo_t[k] = i
                kind = (K_ARRAY if isinstance(t, runtime.Array)
                        else K_VARARRAY)
                lim = t.n if kind == K_ARRAY else t.max_len
                nodes[i] = (kind, lim, t_idx(t.elem))
                return i
            elif isinstance(t, runtime.Optional):
                i = len(nodes)
                nodes.append(None)
                memo_t[k] = i
                nodes[i] = (K_OPT, t_idx(t.elem))
                return i
            else:
                raise TypeError(f"uncompilable XDR type {t!r}")
            i = len(nodes)
            nodes.append(node)
            memo_t[k] = i
            return i

        def c_idx(cls) -> int:
            got = memo_c.get(cls)
            if got is not None:
                return got
            i = len(nodes)
            nodes.append(None)
            memo_c[cls] = i
            if issubclass(cls, runtime.Struct):
                names = []
                idxs = []
                for fn, ft in cls._FIELDS:
                    names.append(sys.intern(fn))
                    idxs.append(t_idx(ft))
                nodes[i] = (K_STRUCT, cls, tuple(names), tuple(idxs))
            else:
                sw = t_idx(cls._SWITCH)
                arms = {}
                for disc, arm in cls._ARMS.items():
                    if arm is None:
                        arms[int(disc)] = (None, -1)
                    else:
                        an, at = arm
                        arms[int(disc)] = (
                            sys.intern(an),
                            t_idx(at) if at is not None else -1)
                d = cls._DEFAULT_ARM
                if d == "_missing_":
                    dd: object = 0          # int = "missing" marker
                elif d is None:
                    dd = None               # void default arm
                else:
                    an, at = d
                    dd = (sys.intern(an) if an is not None else None,
                          t_idx(at) if at is not None else -1)
                nodes[i] = (K_UNION, cls, sw, arms, dd)
            return i

        for cls in list(runtime._XDR_REGISTRY):
            cls._nidx = c_idx(cls)
        cap = self.ext.build(nodes, runtime.XdrError)
        self._keep = (nodes, keep)
        return cap


_STATE: NativeCodec | None = None
_DISABLED = os.environ.get("SC_XDR_NATIVE", "1") == "0"


def state() -> NativeCodec | None:
    global _STATE
    if _DISABLED:
        return None
    if _STATE is None:
        _STATE = NativeCodec()
    return _STATE
