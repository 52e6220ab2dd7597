"""idle_waiting_share of a cell whose end-to-end time is the card's
(round_device_ms)."""

from benchmark.metrics.idle_waiting_share import read  # noqa: F401
