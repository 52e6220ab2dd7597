"""host_sync_ms of a cell whose end-to-end time is the card's
(round_device_ms)."""

from benchmark.metrics.host_sync_ms import read  # noqa: F401
