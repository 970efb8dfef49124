#!/usr/bin/env python3
"""Run the native differential tests under ASan+UBSan.

    python -m stellar_core_tpu_torch.scripts.native_sanitize   # default set
    python -m stellar_core_tpu_torch.scripts.native_sanitize \
        tests/test_torch_native.py -k sign

Builds native/src/*.cpp into a separate libscnative-san_<hash>.so
(`SC_NATIVE_SANITIZE=1`, see native/loader.py), then re-execs pytest
with libasan LD_PRELOADed — an ASan DSO dlopen'd into a plain python
needs the runtime loaded first. UBSan is -fno-sanitize-recover, so any
signed overflow / misaligned load aborts the run; ASan leak checking is
off because the leaks ASan sees are CPython's own arenas, not ours.

Exit code is pytest's. Run it after any native/src change. It is a CPU
job: ASan clashes with the CUDA driver unless ASAN_OPTIONS holds
protect_shadow_gap=0, so keep the card out of the tests it runs.
"""

import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# tests that exercise the native library end-to-end against the pure
# Python / hashlib / reference implementations
DEFAULT_TESTS = ["tests/test_torch_native.py"]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    env = dict(os.environ)
    env["SC_NATIVE_SANITIZE"] = "1"
    env["JAX_PLATFORMS"] = env.get("JAX_PLATFORMS", "cpu")

    libasan = subprocess.run(
        ["gcc", "-print-file-name=libasan.so"],
        capture_output=True, text=True, check=True).stdout.strip()
    if os.sep not in libasan:
        print(f"error: gcc could not locate libasan.so ({libasan!r})",
              file=sys.stderr)
        return 2
    env["LD_PRELOAD"] = libasan
    # detect_leaks=0: CPython interns/arenas dominate any leak report;
    # link-order check stays ON — the preload above satisfies it
    env.setdefault("ASAN_OPTIONS", "detect_leaks=0")

    # force a fresh sanitized build before pytest inherits the preload
    subprocess.run(
        [sys.executable, "-c",
         "from stellar_core_tpu_torch.native import loader; "
         "print(loader.build(force=True))"],
        cwd=REPO_ROOT, env={**env, "LD_PRELOAD": ""}, check=True)

    tests = argv or DEFAULT_TESTS
    cmd = [sys.executable, "-m", "pytest", "-q",
           "-p", "no:cacheprovider"] + tests
    print("+ LD_PRELOAD=" + libasan, "SC_NATIVE_SANITIZE=1",
          " ".join(cmd), flush=True)
    return subprocess.run(cmd, cwd=REPO_ROOT, env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
