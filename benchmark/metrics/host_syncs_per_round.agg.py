"""host_syncs_per_round of a cell whose end-to-end time is the card's
(round_device_ms)."""

from benchmark.metrics.host_syncs_per_round import read  # noqa: F401
