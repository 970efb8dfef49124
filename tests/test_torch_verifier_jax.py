"""The whole slice against the JAX main path: CudaBatchVerifier(device=
"cpu") against TpuBatchVerifier(device_sha=True) and the oracle. Exact
verdicts. A file of its own because the XLA compile of the JAX verifier
is the longest single step of the port's tests, so that pytest-xdist's
--dist loadfile can give it a worker of its own."""

import hashlib

import pytest
import torch

from stellar_core_tpu_torch.crypto import ed25519_ref as tref
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.ops import verifier as V


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


def _mk(n, seed):
    items = []
    for i in range(n):
        sk = SecretKey.pseudo_random_for_testing(seed * 1000 + i)
        msg = hashlib.sha256(b"msg%d-%d" % (seed, i)).digest()
        items.append((sk.public_key().raw, sk.sign(msg), msg))
    return items


def _oracle(items):
    return [tref.verify(p, s, m) for p, s, m in items]


def test_matches_jax_tpu_verifier():
    """8 tuples (bucket 8, the shape the JAX suite already compiles),
    valid and corrupted, through JAX TpuBatchVerifier(device_sha=True)."""
    from stellar_core_tpu.ops.verifier import TpuBatchVerifier
    items = _mk(8, seed=41)
    p, s, m = items[2]
    items[2] = (p, s[:10] + bytes([s[10] ^ 1]) + s[11:], m)
    p, s, m = items[5]
    items[5] = (bytes([p[0] ^ 4]) + p[1:], s, m)
    p, s, m = items[6]
    items[6] = (p, s[:32] + bytes(32), m)
    want = TpuBatchVerifier(device_sha=True).verify_tuples(items)
    got = V.CudaBatchVerifier(device="cpu").verify_tuples(items)
    assert got == [bool(x) for x in want] == _oracle(items)
    assert sum(got) == 5
