"""The 95th percentile of the window's round durations, ms: at the
arbiter, from aggregate_and_broadcast's start to the convergence
broadcast (agg traffic), or between the guest's round ends (train)."""

import numpy as np


def read(run):
    if not run.out.round_s:
        return None
    return float(np.percentile(np.asarray(run.out.round_s) * 1e3, 95))
