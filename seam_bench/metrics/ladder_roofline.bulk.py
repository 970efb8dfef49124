"""ladder_roofline.bulk: see readers.ladder_roofline."""

from seam_bench.readers import ladder_roofline as read  # noqa: F401
