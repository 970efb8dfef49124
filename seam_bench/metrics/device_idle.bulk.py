"""device_idle.bulk: see readers.device_idle."""

from seam_bench.readers import device_idle as read  # noqa: F401
