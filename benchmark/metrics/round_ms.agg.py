"""round_ms of a cell whose end-to-end time is the card's (the window over
the rounds completed in it, ms, host clock; in a traced run, with the
roles' phases synchronized)."""

from benchmark.metrics.round_ms import read  # noqa: F401
