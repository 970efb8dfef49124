"""setup_s: see readers.setup_s."""

from seam_bench.readers import setup_s as read  # noqa: F401
