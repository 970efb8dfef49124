"""The host C++ Ed25519 verifier (a copy of the JAX package's native/src).

Built on first use with g++ into build/; see loader.py.
"""
