"""Build csrc/ with nvcc into a shared library and load it with ctypes.

The library has a plain C interface (csrc/ed25519.cu), so it needs no
PyTorch headers and nvcc builds it in seconds. It is built at first use
into ops/build/, named by a hash of the sources and flags; the build
writes a temporary file and renames it, so processes building at once
do not clash. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# filled by build(): library path, seconds spent in nvcc (0 when the
# library was already built), and the compiler's -Xptxas -v report
info = {}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile csrc/ed25519.cu unless this source hash is built; returns
    the library path. Raises with the compiler output on failure."""
    key = _key()
    path = os.path.join(BUILD, f"libed25519_{key}.so")
    log = path[:-3] + ".log"
    if os.path.exists(path) and os.path.exists(log):
        with open(log) as f:
            info.update(path=path, seconds=0.0, ptxas=f.read())
        return path
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
           os.path.join(CSRC, "ed25519.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    with open(log + f".{os.getpid()}.tmp", "w") as f:
        f.write(res.stdout + res.stderr)
    os.replace(log + f".{os.getpid()}.tmp", log)
    os.replace(tmp, path)
    info.update(path=path, seconds=seconds, ptxas=res.stdout + res.stderr)
    return path


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            dll = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            dll.ed25519_prep_launch.argtypes = [p, p, p, p, i, p, p, p, i, p]
            dll.ed25519_prep_launch.restype = i
            dll.ed25519_ladder_launch.argtypes = [p, p, p, p, p, p, i, p]
            dll.ed25519_ladder_launch.restype = i
            dll.ed25519_kernel_info.argtypes = [i, ctypes.POINTER(i)]
            dll.ed25519_kernel_info.restype = i
            dll.ed25519_error_string.argtypes = [i]
            dll.ed25519_error_string.restype = ctypes.c_char_p
            _lib = dll
        return _lib


KERNELS = ("ed25519_prep", "ed25519_ladder")


def kernel_info(name: str) -> dict:
    """Launch geometry and resources of a kernel, from the CUDA runtime:
    threads per block and per signature, resident blocks per SM,
    registers and local (spill and stack) bytes per thread, static shared
    bytes per block."""
    info = (ctypes.c_int * 6)()
    err = lib().ed25519_kernel_info(KERNELS.index(name), info)
    if err:
        raise RuntimeError(f"kernel_info({name}): {error_string(err)}")
    keys = ("block", "threads_per_sig", "blocks_per_sm", "regs",
            "local_bytes", "shared_bytes")
    return dict(zip(keys, info))


def error_string(err: int) -> str:
    return f"CUDA error {err}: {lib().ed25519_error_string(err).decode()}"
