"""The device's side of a traced run: torch.profiler with CUDA activity
over the window, read as intervals on the host's perf_counter clock.

The profiler's events carry nanoseconds of CLOCK_MONOTONIC (perf_counter's
clock on Linux) or of the wall clock; `Tracer.kernels` places them on
perf_counter by whichever of the two puts them inside the traced interval.
A run with no CUDA records (no card, or CUPTI silent) reads as None, and
the metrics that need the device leave themselves out."""

from __future__ import annotations

import time

__all__ = ["Tracer", "DeviceTrace", "busy_intervals"]


class DeviceTrace:
    """The device's records of one window: (name, start, end) in
    perf_counter seconds, clipped to nothing (the readers clip)."""

    def __init__(self, ops):
        self.ops = sorted(ops, key=lambda o: o[1])

    def busy(self, t0: float, t1: float):
        """Merged busy intervals inside [t0, t1]."""
        return busy_intervals(self.ops, t0, t1)

    def time_by_name(self, t0: float, t1: float) -> dict:
        out = {}
        for name, b, e in self.ops:
            b, e = max(b, t0), min(e, t1)
            if e > b:
                out[name] = out.get(name, 0.0) + (e - b)
        return out


def busy_intervals(ops, t0, t1):
    merged = []
    for _, b, e in ops:
        b, e = max(b, t0), min(e, t1)
        if e <= b:
            continue
        if merged and b <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([b, e])
    return merged


class Tracer:
    def __init__(self):
        self.prof = None
        self.span = None  # (perf_counter at start, at stop)
        self.wall_offset = 0.0  # time.time() - perf_counter()

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.wall_offset = time.time() - time.perf_counter()
        self.span = [time.perf_counter(), None]

    def stop(self):
        self.span[1] = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def device_trace(self):
        """The CUDA records as a DeviceTrace, or None where there are none."""
        from torch.autograd import DeviceType

        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start = e.start_ns() if hasattr(e, "start_ns") else \
                e.start_us() * 1e3
            dur = e.duration_ns() if hasattr(e, "duration_ns") else \
                e.duration_us() * 1e3
            raw.append((e.name(), start * 1e-9, (start + dur) * 1e-9))
        if not raw:
            return None
        first = min(b for _, b, _ in raw)
        lo, hi = self.span[0] - 1.0, self.span[1] + 1.0
        shift = 0.0 if lo <= first <= hi else -self.wall_offset
        return DeviceTrace([(n, b + shift, e + shift) for n, b, e in raw])
