"""host_dispatch_ms.bulk: see readers.host_dispatch_ms."""

from seam_bench.readers import host_dispatch_ms as read  # noqa: F401
