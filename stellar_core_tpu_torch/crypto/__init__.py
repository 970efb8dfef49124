"""Strict Ed25519 oracle, keys and hashing (copies of the JAX package's)."""
