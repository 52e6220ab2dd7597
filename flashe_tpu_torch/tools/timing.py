"""Timing helpers for the card: CUDA events, runs of calls, CUDA graphs;
and the kernels' launch counts that a measurement reads around itself.

PyTorch returns before the card finishes, so a host clock without a
synchronize measures the enqueue.  Each helper here ends its window on the
card: a pair of CUDA events around one call (`event_ms`) or around a run
of back-to-back calls (`run_ms`, the card's rate as long as the host
launches faster than the card runs), or the replay of a CUDA graph of
calls (`graph_ms`, the card's rate whatever the host's launch rate is).
`host_run_s` is the host clock over a run of calls that ends in one
synchronize: what a caller on the host pays, launches included, on the
card or on the CPU; `timeit` the same for one call after a warm one.
Nothing here runs at import time.
"""

from __future__ import annotations

import statistics
import time

import torch

from flashe_tpu_torch.device import synchronize

__all__ = ["event_ms", "run_ms", "time_turns", "graph_ms", "sync",
           "host_run_s", "timeit", "device_run_ms", "launch_counts",
           "launches_since"]


def event_ms(fn, reps):
    """Per-call milliseconds of fn() with CUDA events, one pair per call."""
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def run_ms(fn, reps):
    """Milliseconds a call of fn() over a run of reps back-to-back calls
    between one pair of CUDA events (the card's rate, as long as the host
    launches faster than the card runs)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def time_turns(kern, plain, reps, plain_reps):
    """ms a call of kern() and of plain() on the same inputs: runs of reps
    (plain_reps) calls in turns plain, kernel, kernel, plain after one
    warm-up call of each; the mean of the two runs of each."""
    for f in (kern, plain):
        f()
    samples = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        if name == "kernel":
            samples[name].append(run_ms(kern, reps))
        else:
            samples[name].append(run_ms(plain, plain_reps))
    return (statistics.mean(samples["kernel"]),
            statistics.mean(samples["plain"]))


def graph_ms(fn, reps):
    """Milliseconds a call of fn() with reps calls captured in one CUDA
    graph and the graph replayed: the card's rate, whatever the host's
    launch rate is.  fn() runs once before the capture, so that what it
    builds or uploads once is there; torch.cuda.graph captures on a side
    stream, and what the calls allocate comes from the graph's own pool."""
    fn()
    synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ms = run_ms(graph.replay, 1) / reps
    del graph
    return ms


def sync(device: torch.device):
    """Wait for the card's work on `device` (nothing on the CPU), never
    beside a capture (device.synchronize)."""
    if device.type == "cuda":
        synchronize(device)


def host_run_s(fn, reps, device: torch.device) -> float:
    """Seconds a call of fn() over a run of reps back-to-back calls, host
    clock, the run ending in one synchronize of `device`."""
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / reps


def timeit(f, device: torch.device, warm: bool = True):
    """(seconds, result) of one call of f, host clock, after a warm call;
    on the card each call ends in a synchronize, so the time holds the
    host's work and the card's together."""
    if warm:
        f()
        sync(device)
    t0 = time.perf_counter()
    out = f()
    sync(device)
    return time.perf_counter() - t0, out


def device_run_ms(fn, reps, device: torch.device) -> float:
    """run_ms on a card; on the CPU, where torch's ops return when they are
    done, host_run_s in milliseconds."""
    if device.type == "cuda":
        return run_ms(fn, reps)
    return host_run_s(fn, reps, device) * 1e3


def launch_counts() -> dict:
    """Every kernel wrapper's launch count: the mask kernel's by mode, the
    Montgomery kernels', the ceiling kernels'."""
    from flashe_tpu_torch.ops import flashe_mask, montgomery
    from flashe_tpu_torch.tools import ceiling

    return dict({f"mask {k}": v for k, v in flashe_mask.mode_launches.items()},
                **montgomery.launches, **ceiling.launches)


def launches_since(before: dict) -> dict:
    """The counts that moved since `before` (launch_counts())."""
    return {k: v - before[k] for k, v in launch_counts().items()
            if v != before[k]}
