"""The whole round's share of the card's peak, %: the round's least time
over its measured time (round_ms).  The least time is the frozen bound of
the round's mask launches plus the bytes of the arbiter's sum and of the
clients' codec passes at the published HBM rate: it still bounds a claim
once a change fuses a kernel away.  Read only in a traced run."""

from benchmark import roofline
from benchmark.metrics import mask_bound_s


def read(run):
    out = run.out
    if run.trace is None or out.kind != "agg":
        return None
    mask = mask_bound_s(run)
    if mask is None:
        return None
    nbytes = (roofline.sum_bytes(out.lanes, out.clients)
              + roofline.codec_bytes(out.lanes, out.clients)) * out.rounds
    least = mask + nbytes / roofline.HBM_BYTES_PER_S
    return least / (out.t1 - out.t0) * 100.0
