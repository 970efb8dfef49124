"""prep_roofline.bulk: see readers.prep_roofline."""

from seam_bench.readers import prep_roofline as read  # noqa: F401
