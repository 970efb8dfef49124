"""verifies_per_s: see readers.verifies_per_s."""

from seam_bench.readers import verifies_per_s as read  # noqa: F401
