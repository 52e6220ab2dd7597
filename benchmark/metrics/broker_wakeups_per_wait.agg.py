"""broker_wakeups_per_wait of a cell whose end-to-end time is the card's
(round_device_ms)."""

from benchmark.metrics.broker_wakeups_per_wait import read  # noqa: F401
