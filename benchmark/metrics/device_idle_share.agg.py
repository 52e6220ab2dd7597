"""device_idle_share of a cell whose end-to-end time is the card's (round_device_ms)."""

from benchmark.metrics.device_idle_share import read  # noqa: F401
