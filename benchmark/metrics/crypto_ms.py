"""The guest's "encryption" + "decryption" phases a window round, ms
(cipher layer and the mask kernel)."""

from benchmark.metrics import phase_ms


def read(run):
    return phase_ms(run, "guest", ("encryption", "decryption"))
