"""mask_roofline_share of a cell whose end-to-end time is the card's (round_device_ms)."""

from benchmark.metrics.mask_roofline_share import read  # noqa: F401
