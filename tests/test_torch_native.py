"""The port's host C++ library (stellar_core_tpu_torch/native/, built
with g++ at first use into its ignored build/ directory) against the
strict oracle and the JAX package's native library: the same verdicts
on the differential corpus, byte-identical signatures and public keys.
Where the library cannot build, the oracle serves."""

import hashlib
import os

import numpy as np
import pytest

from stellar_core_tpu.crypto import keys as jkeys
from stellar_core_tpu.native import loader as jloader
from stellar_core_tpu_torch.crypto import ed25519_ref as tref
from stellar_core_tpu_torch.crypto import keys as tkeys
from stellar_core_tpu_torch.native import loader
from stellar_core_tpu_torch.ops.testvectors import make_differential_vectors


@pytest.fixture(scope="module")
def lib():
    return loader.get_lib()


@pytest.fixture(scope="module")
def jlib():
    """The JAX package's library in its fast build, also where
    SC_NATIVE_SANITIZE=1 (the sanitizer job) selects the port's sanitized
    one: the JAX package keeps a prebuilt sanitized library, linked against
    the libasan of the machine that built it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("SC_NATIVE_SANITIZE", raising=False)
        return jloader.get_lib()


@pytest.fixture(scope="module")
def corpus():
    return make_differential_vectors(24, seed=31)


def test_builds_into_ignored_dir_with_generated_header(lib):
    assert os.path.dirname(lib.path) == loader.BUILD
    assert loader.BUILD.endswith(os.path.join("stellar_core_tpu_torch",
                                              "native", "build"))
    hdr = os.path.join(os.path.dirname(loader.__file__), "src",
                       "sha512_consts.h")
    with open(hdr) as f:
        assert f.read() == loader.gen_consts_header()
    for name in ("ed25519.cpp", "sha512.cpp", "sha512_consts.h"):
        with open(os.path.join(os.path.dirname(jloader.__file__), "src",
                               name), "rb") as f:
            ref_src = f.read()
        with open(os.path.join(os.path.dirname(loader.__file__), "src",
                               name), "rb") as f:
            assert f.read() == ref_src, name
    assert loader.build() == lib.path     # built once: no rebuild
    assert tkeys.host_verifier() == "native"


def test_verify_matches_oracle_and_reference_native(lib, jlib, corpus):
    got = [lib.verify(p, s, m) for p, s, m in corpus]
    assert got == [tref.verify(p, s, m) for p, s, m in corpus]
    assert got == [jlib.verify(p, s, m) for p, s, m in corpus]
    assert got == [tkeys.verify_sig_uncached(p, s, m) for p, s, m in corpus]
    assert 0 < sum(got) < len(got)
    p, s, m = corpus[0]
    assert lib.verify(p, s, m)
    # lengths the C side would over-read never reach it
    assert not lib.verify(p[:31], s, m) and not lib.verify(p, s[:63], m)
    with pytest.raises(ValueError):
        lib.sign(p[:31], p, m)
    with pytest.raises(ValueError):
        lib.public_from_seed(b"short")


def test_sign_and_public_from_seed_identical_to_reference(lib, jlib):
    rng = np.random.default_rng(17)
    for i in range(6):
        seed = rng.bytes(32)
        msg = rng.bytes(int(rng.integers(0, 300)))
        pub = lib.public_from_seed(seed)
        assert pub == jlib.public_from_seed(seed) == \
            tref.secret_to_public(seed)
        sig = lib.sign(seed, pub, msg)
        assert sig == jlib.sign(seed, pub, msg) == tref.sign(seed, msg)
        tk, jk = tkeys.SecretKey.from_seed(seed), jkeys.SecretKey(seed)
        assert tk.public_key().raw == jk.public_key().raw == pub
        assert tk.sign(msg) == jk.sign(msg) == sig
    for n in (0, 1, 111, 112, 128, 1000):
        data = rng.bytes(n)
        assert lib.sha512(data) == hashlib.sha512(data).digest()


def test_oracle_serves_when_the_library_cannot_build(monkeypatch, corpus):
    """A failed build is remembered (no retry per call); verify, sign and
    key derivation fall back to the oracle with the same bytes."""
    calls = []

    def no_compiler():
        calls.append(1)
        raise RuntimeError("g++ failed (127)")

    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_error", None)
    monkeypatch.setattr(loader, "build", no_compiler)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        loader.get_lib()
    with pytest.raises(RuntimeError, match="unavailable"):
        loader.get_lib()
    assert tkeys.host_verifier() == "oracle"
    items = corpus[:12]
    assert [tkeys.verify_sig_uncached(p, s, m) for p, s, m in items] == \
        [tref.verify(p, s, m) for p, s, m in items]
    sk = tkeys.SecretKey.pseudo_random_for_testing(5)
    jk = jkeys.SecretKey.pseudo_random_for_testing(5)
    assert sk.public_key().raw == jk.public_key().raw
    assert sk.sign(b"m") == jk.sign(b"m")
    assert calls == [1]
