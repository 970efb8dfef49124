"""Build csrc/ with nvcc into a shared library and load it with ctypes.

The library has a plain C interface (csrc/ed25519.cu), so it needs no
PyTorch headers and nvcc builds it in seconds. It is built at first use
into ops/build/, named by a hash of the sources and flags; the build
writes a temporary file and renames it, so processes building at once
do not clash. Nothing here runs at import.

A variant (`build(defines)`, `lib(defines)`) is the same source compiled
with preprocessor macros: the launch geometry of `KNOBS` set to other
values, or `WINDOWS_ONLY`, which adds the entry
`ed25519_ladder_windows_launch` (the ladder without its Z^-1 epilogue,
for measuring it). Its library is hashed over the defines too, into the
same directory. The main path only ever loads the default library,
`lib()`; a variant's build report goes to `variant_info`, not `info`.
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

# the launch geometry constants of csrc/ed25519.cu and the macro that
# overrides each; the defaults are the sources'
KNOBS = {"kPrepThreads": "ED25519_PREP_THREADS",
         "kPrepMinBlocks": "ED25519_PREP_MIN_BLOCKS",
         "kLadderThreads": "ED25519_LADDER_THREADS",
         "kLadderMinBlocks": "ED25519_LADDER_MIN_BLOCKS"}
WINDOWS_ONLY = "ED25519_LADDER_WINDOWS_ONLY"

_lock = threading.Lock()
_lib = None
_variants = {}
# filled by build(): library path, seconds spent in nvcc (0 when the
# library was already built), and the compiler's -Xptxas -v report; of
# the default library in `info`, of a variant in variant_info[defines]
info = {}
variant_info = {}


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


def defines_of(knobs: dict) -> tuple:
    """The defines of a variant: {"kLadderThreads": 64} ->
    ("ED25519_LADDER_THREADS=64",)."""
    for name in knobs:
        if name not in KNOBS:
            raise ValueError(f"unknown knob {name!r} (known: "
                             f"{', '.join(KNOBS)})")
    return _canonical(f"{KNOBS[name]}={int(value)}"
                      for name, value in knobs.items())


def _canonical(defines) -> tuple:
    return tuple(sorted(set(defines)))


def _flags(defines) -> list:
    return NVCC_FLAGS + [f"-D{d}" for d in _canonical(defines)]


def _key(defines=()) -> str:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(defines=()) -> str:
    """Compile csrc/ed25519.cu with these defines unless this hash of
    sources, flags and defines is built; returns the library path.
    Raises with the compiler output on failure."""
    defines = _canonical(defines)
    report = variant_info.setdefault(defines, {}) if defines else info
    key = _key(defines)
    path = os.path.join(BUILD, f"libed25519_{key}.so")
    log = path[:-3] + ".log"
    if os.path.exists(path) and os.path.exists(log):
        with open(log) as f:
            report.update(path=path, seconds=0.0, ptxas=f.read())
        return path
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_flags(defines), "-I", CSRC, "-o", tmp,
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
    report.update(path=path, seconds=seconds, ptxas=res.stdout + res.stderr)
    return path


def _load(path: str, windows: bool):
    dll = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ed25519_prep_launch.argtypes = [p, p, p, p, i, p, p, p, i, p]
    dll.ed25519_prep_launch.restype = i
    dll.ed25519_ladder_launch.argtypes = [p, p, p, p, i, p, p, p, p, p, i,
                                          p]
    dll.ed25519_ladder_launch.restype = i
    if windows:
        dll.ed25519_ladder_windows_launch.argtypes = [p, p, p, p, i, p, p, p,
                                                      i, p]
        dll.ed25519_ladder_windows_launch.restype = i
    dll.ed25519_kernel_info.argtypes = [i, ctypes.POINTER(i)]
    dll.ed25519_kernel_info.restype = i
    dll.ed25519_error_string.argtypes = [i]
    dll.ed25519_error_string.restype = ctypes.c_char_p
    return dll


def lib(defines=()):
    """The loaded kernel library (built on first call): the default one,
    or the variant compiled with these defines."""
    global _lib
    defines = _canonical(defines)
    with _lock:
        if not defines:
            if _lib is None:
                _lib = _load(build(), False)
            return _lib
        if defines not in _variants:
            _variants[defines] = _load(build(defines),
                                       WINDOWS_ONLY in defines)
        return _variants[defines]


KERNELS = ("ed25519_prep", "ed25519_ladder")
WINDOWS_KERNEL = "ed25519_ladder_windows"   # only in a WINDOWS_ONLY variant


def kernel_info(name: str, defines=()) -> dict:
    """Launch geometry and resources of a kernel, from the CUDA runtime:
    threads per block and per signature, resident blocks per SM,
    registers and local (spill and stack) bytes per thread, static shared
    bytes per block."""
    info = (ctypes.c_int * 6)()
    err = lib(defines).ed25519_kernel_info(
        (*KERNELS, WINDOWS_KERNEL).index(name), info)
    if err:
        raise RuntimeError(f"kernel_info({name}): {error_string(err)}")
    keys = ("block", "threads_per_sig", "blocks_per_sm", "regs",
            "local_bytes", "shared_bytes")
    return dict(zip(keys, info))


def error_string(err: int) -> str:
    return f"CUDA error {err}: {lib().ed25519_error_string(err).decode()}"
