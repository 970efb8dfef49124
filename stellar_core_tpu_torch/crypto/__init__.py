"""Strict Ed25519 oracle and keys (copies of the JAX package's)."""
