"""Build + load the host C++ Ed25519 library (ctypes, no pybind11).

The sources in src/ are copies of the JAX package's native/src. As its
loader does, this one generates the SHA-512 round constants from first
principles (fractional bits of cube/square roots of the first primes,
FIPS 180-4 §4.2.3) into src/sha512_consts.h, then compiles src/*.cpp
with g++ into build/libscnative_<hash>.so, named by a hash of the
sources and flags. The header is rewritten only when its text differs,
and the library is written to a temporary file and renamed, so
processes building at once do not clash. Nothing here runs at import.

SC_NATIVE_SANITIZE=1 selects the ASan+UBSan build. Its flags differ, so
its hash and its file (build/libscnative-san_<hash>.so) do too, and it
never replaces the fast library. Load it through
`python -m stellar_core_tpu_torch.scripts.native_sanitize`, which
LD_PRELOADs libasan: an ASan library dlopen'ed into a plain python
otherwise trips ASan's link-order check.

A build that fails is remembered: `get_lib` raises at once afterwards,
and callers (crypto/keys.py) fall back to the strict oracle.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src")
BUILD = os.path.join(_DIR, "build")
FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-pthread"]
# -O1 keeps stack traces honest; UBSan aborts on the first report, so a
# signed overflow or a misaligned load fails the test run loudly
SANITIZE_FLAGS = ["-O1", "-g", "-fno-omit-frame-pointer",
                  "-fsanitize=address,undefined",
                  "-fno-sanitize-recover=undefined", "-march=native",
                  "-std=c++17", "-shared", "-fPIC", "-pthread"]


def sanitize_enabled() -> bool:
    return os.environ.get("SC_NATIVE_SANITIZE", "") == "1"

_lock = threading.Lock()
_lib: Optional["NativeLib"] = None
_error: Optional[BaseException] = None


def _primes(n: int) -> list:
    ps, c = [], 2
    while len(ps) < n:
        if all(c % p for p in ps):
            ps.append(c)
        c += 1
    return ps


def _icbrt(n: int) -> int:
    """Integer cube root via Newton iteration on Python ints."""
    if n == 0:
        return 0
    x = 1 << ((n.bit_length() + 2) // 3)
    while True:
        y = (2 * x + n // (x * x)) // 3
        if y >= x:
            return x
        x = y


def gen_consts_header() -> str:
    # K_i = first 64 fractional bits of cbrt(prime_i); H0_i likewise for sqrt
    ks = []
    for p in _primes(80):
        frac = _icbrt(p << 192)  # floor(cbrt(p) * 2^64)
        ks.append(frac & ((1 << 64) - 1))
    hs = []
    for p in _primes(8):
        frac = math.isqrt(p << 128)  # floor(sqrt(p) * 2^64)
        hs.append(frac & ((1 << 64) - 1))
    lines = ["// generated by loader.py — do not edit", "#pragma once",
             "#include <cstdint>",
             "static const uint64_t SHA512_K[80] = {"]
    for i in range(0, 80, 4):
        lines.append("    " + ", ".join(f"0x{k:016x}ULL" for k in ks[i:i + 4]) + ",")
    lines.append("};")
    lines.append("static const uint64_t SHA512_H0[8] = {")
    for i in range(0, 8, 4):
        lines.append("    " + ", ".join(f"0x{h:016x}ULL" for h in hs[i:i + 4]) + ",")
    lines.append("};")
    return "\n".join(lines) + "\n"


def _write_header() -> None:
    hdr = os.path.join(_SRC, "sha512_consts.h")
    text = gen_consts_header()
    if os.path.exists(hdr):
        with open(hdr) as f:
            if f.read() == text:
                return
    tmp = f"{hdr}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, hdr)


def _sources() -> list:
    return sorted(os.path.join(_SRC, f) for f in os.listdir(_SRC)
                  if f.endswith((".cpp", ".h")))


def build_hashed(directory: str, stem: str, flags: list, sources: list,
                 command, force: bool = False) -> str:
    """The library `directory`/`stem`_<hash>.so, the hash over `flags`
    and each of `sources` (its name and bytes), compiled unless it is
    built (or `force`): `command(out)` is the compiler's argv writing to
    `out`, a temporary file then renamed into place, so processes that
    build at once each load a whole library. Raises with the compiler
    output on failure."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    so = os.path.join(directory, f"{stem}_{h.hexdigest()[:16]}.so")
    if os.path.exists(so) and not force:
        return so
    os.makedirs(directory, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = command(tmp)
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    return so


def build(force: bool = False) -> str:
    """Compile src/*.cpp unless this source hash is built (or `force`),
    with the sanitizers under SC_NATIVE_SANITIZE=1; returns the library
    path. Raises with the compiler output on failure."""
    _write_header()
    san = sanitize_enabled()
    flags = SANITIZE_FLAGS if san else FLAGS
    cpp = [s for s in _sources() if s.endswith(".cpp")]
    return build_hashed(BUILD, "libscnative-san" if san else "libscnative",
                        flags, _sources(),
                        lambda out: ["g++"] + flags + ["-o", out] + cpp,
                        force)


class NativeLib:
    """Typed wrapper over libscnative: the calls the port needs."""

    def __init__(self, so_path: str):
        self.path = so_path
        self._c = ctypes.CDLL(so_path)
        c = self._c
        c.sc_sha512.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                ctypes.c_char_p]
        c.sc_sha512.restype = None
        c.sc_ed25519_verify.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_char_p, ctypes.c_size_t]
        c.sc_ed25519_verify.restype = ctypes.c_int
        c.sc_ed25519_public_from_seed.argtypes = [ctypes.c_char_p,
                                                  ctypes.c_char_p]
        c.sc_ed25519_public_from_seed.restype = None
        c.sc_ed25519_sign.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_char_p]
        c.sc_ed25519_sign.restype = None
        u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
        c.sc_ed25519_batch_verify.argtypes = [u8p, u8p, u8p, u64p,
                                              ctypes.c_uint64, u8p]
        c.sc_ed25519_batch_verify.restype = None
        c.sc_ed25519_batch_prepare.argtypes = [u8p, u8p, u8p, u64p,
                                               ctypes.c_uint64, u8p, u8p]
        c.sc_ed25519_batch_prepare.restype = None
        c.sc_ed25519_batch_host_precheck.argtypes = [
            u8p, u8p, ctypes.c_uint64, u8p, u8p]
        c.sc_ed25519_batch_host_precheck.restype = None
        self._selftest()

    def _selftest(self) -> None:
        # differential sanity vs hashlib on a few lengths
        for n in (0, 1, 63, 64, 111, 112, 127, 128, 300):
            data = bytes(range(256))[:n]
            if self.sha512(data) != hashlib.sha512(data).digest():
                raise RuntimeError(f"native sha512 mismatch at len {n}")

    def sha512(self, data: bytes) -> bytes:
        out = ctypes.create_string_buffer(64)
        self._c.sc_sha512(data, len(data), out)
        return out.raw

    def verify(self, pub: bytes, sig: bytes, msg: bytes) -> bool:
        # the C side reads 32 and 64 bytes: other lengths never verify
        if len(pub) != 32 or len(sig) != 64:
            return False
        return bool(self._c.sc_ed25519_verify(pub, sig, msg, len(msg)))

    def public_from_seed(self, seed: bytes) -> bytes:
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        out = ctypes.create_string_buffer(32)
        self._c.sc_ed25519_public_from_seed(seed, out)
        return out.raw

    def sign(self, seed: bytes, pub: bytes, msg: bytes) -> bytes:
        """RFC 8032 detached signature (byte-identical to libsodium /
        ed25519_ref.sign); `pub` is the caller's cached public key."""
        if len(seed) != 32 or len(pub) != 32:
            raise ValueError("seed and public key must be 32 bytes")
        out = ctypes.create_string_buffer(64)
        self._c.sc_ed25519_sign(seed, pub, msg, len(msg), out)
        return out.raw

    def batch_verify(self, pubs: np.ndarray, sigs: np.ndarray,
                     msgs: bytes, offsets: np.ndarray) -> np.ndarray:
        """CPU batch baseline, one thread: (n,) bool verdicts of the
        strict verify. Message i is msgs[offsets[i]:offsets[i+1]]."""
        n = pubs.shape[0]
        offsets = self._offsets(pubs, sigs, msgs, offsets, "batch_verify")
        results = np.zeros(n, dtype=np.uint8)
        self._c.sc_ed25519_batch_verify(
            np.ascontiguousarray(pubs, dtype=np.uint8),
            np.ascontiguousarray(sigs, dtype=np.uint8),
            np.frombuffer(msgs or b"\0", dtype=np.uint8), offsets, n,
            results)
        return results.astype(bool)

    @staticmethod
    def _offsets(pubs, sigs, msgs, offsets, what):
        """The offsets as the C side reads them, after checking that they
        delimit len(msgs) bytes in order for n public keys and
        signatures: the C side trusts them."""
        n = pubs.shape[0]
        offsets = np.ascontiguousarray(offsets, dtype=np.uint64)
        if pubs.shape != (n, 32) or sigs.shape != (n, 64) \
                or offsets.shape != (n + 1,) or int(offsets[-1]) != len(msgs) \
                or (offsets[1:] < offsets[:-1]).any():
            raise ValueError(f"{what}: inconsistent shapes")
        return offsets

    def batch_prepare(self, pubs: np.ndarray, sigs: np.ndarray,
                      msgs: bytes, offsets: np.ndarray):
        """k = SHA512(R‖A‖M) mod L per signature ((n,32) uint8) and the
        S < L flags ((n,) bool). Message i is msgs[offsets[i]:offsets[i+1]]."""
        n = pubs.shape[0]
        offsets = self._offsets(pubs, sigs, msgs, offsets, "batch_prepare")
        k_out = np.zeros((n, 32), dtype=np.uint8)
        s_ok = np.zeros(n, dtype=np.uint8)
        # a 1-byte buffer stands in for an empty blob: C reads none of it
        blob = np.frombuffer(msgs or b"\0", dtype=np.uint8)
        self._c.sc_ed25519_batch_prepare(
            np.ascontiguousarray(pubs, dtype=np.uint8),
            np.ascontiguousarray(sigs, dtype=np.uint8), blob, offsets, n,
            k_out, s_ok)
        return k_out, s_ok.astype(bool)

    def batch_host_precheck(self, pubs: np.ndarray, sigs: np.ndarray):
        """Strict decompression and small-order checks of A and R:
        (-A as canonical x‖y bytes (n,64) uint8, ok (n,) bool)."""
        n = pubs.shape[0]
        if pubs.shape != (n, 32) or sigs.shape != (n, 64):
            raise ValueError("batch_host_precheck: inconsistent shapes")
        neg_a_xy = np.zeros((n, 64), dtype=np.uint8)
        ok = np.zeros(n, dtype=np.uint8)
        self._c.sc_ed25519_batch_host_precheck(
            np.ascontiguousarray(pubs, dtype=np.uint8),
            np.ascontiguousarray(sigs, dtype=np.uint8), n, neg_a_xy, ok)
        return neg_a_xy, ok.astype(bool)


def get_lib() -> NativeLib:
    """The loaded library, built on first call. A failed build or load
    is raised again on every later call without retrying."""
    global _lib, _error
    with _lock:
        if _lib is None:
            if _error is not None:
                raise RuntimeError(f"native library unavailable: {_error}")
            try:
                _lib = NativeLib(build())
            except Exception as e:
                _error = e
                raise
        return _lib
