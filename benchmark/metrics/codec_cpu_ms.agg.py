"""codec_cpu_ms of a cell whose end-to-end time is the card's
(round_device_ms)."""

from benchmark.metrics.codec_cpu_ms import read  # noqa: F401
