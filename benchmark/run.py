"""Run one cell of the benchmark and print its result as one JSON line.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

from the repository's root (or a checkout of it).  The run makes its
weights and rows from the seed on the card, warms up the cell's own
shapes, times whole federated rounds of flashe_tpu_torch for about S
seconds, checks what the timed path produced against the plain reference
(benchmark/reference), and prints {"correct", "attempted", "failed",
"metrics", "device", ["breakdown"], "checks"}: with --trace 0 the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read from the
roles' phases (synchronized at each phase's ends) and from torch.profiler.
Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result; if the process has loaded JAX, flax or the JAX package
it exits 3 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = ROOT  # import the harness as the package `benchmark`
FORBIDDEN = ("jax", "jaxlib", "flax", "flashe_tpu")


def _caches(root: str):
    """Every compile cache inside the checkout, at a fixed path."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(root, "build", "benchmark", sub)


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's, jaxlib's, flax's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _gaps(trace, out, limit=10):
    """The window's longest idle gaps, each named by the guest's or the
    arbiter's phase open at its middle."""
    busy = trace.busy(out.t0, out.t1)
    edges = [out.t0] + [x for b, e in busy for x in (b, e)] + [out.t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)), reverse=True)[:limit]
    named = []
    for length, b, e in gaps:
        mid = (b + e) / 2
        label = "no phase"
        for role in ("guest", "arbiter"):
            open_ = [n for n, pb, pe in out.spans.get(role, ())
                     if pb <= mid <= pe]
            if open_:
                label = f"{role}: {open_[-1]}"
                break
        named.append([label, length])
    return named


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float):
    """One run of cell `name` on `device`; returns (result dict, checks,
    the window's Outcome) where checks is [(number, value, limit)]."""
    import torch

    from benchmark import check, drive, metrics
    from benchmark.cells import load_cell
    from benchmark.devtrace import Tracer
    from benchmark.reference import strict_fp32

    device = torch.device(device)
    cell = load_cell(root, name)
    # The profiler runs in a traced run, and in an untraced one wherever
    # an end-to-end metric of the cell is read from the device's records.
    profile = trace or any(m["source"] == "device_trace"
                           for m in cell.end_to_end)
    tracer = Tracer() if profile and device.type == "cuda" else None
    out = drive.drive(cell, seed, seconds, trace, device, tracer)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    dtrace = tracer.device_trace() if tracer is not None else None

    run = types.SimpleNamespace(out=out, trace=dtrace,
                                setup_s=out.t0 - t_start)
    wanted = cell.per_layer if trace else cell.end_to_end
    values = {}
    for m in wanted:
        v = metrics.read(m["name"], run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    strict_fp32()
    checks = check.check(out, cell.limits, device)
    failed = sum(1 for _, v, lim in checks if not v <= lim)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": failed == 0, "attempted": out.rounds,
              "failed": failed, "metrics": values, "device": dev}
    if trace:
        window = out.t1 - out.t0
        busy = (sum(e - b for b, e in dtrace.busy(out.t0, out.t1))
                if dtrace is not None else 0.0)
        dev.update(busy_s=busy, window_s=window)
        if dtrace is not None:
            ops = sorted(dtrace.time_by_name(out.t0, out.t1).items(),
                         key=lambda kv: -kv[1])[:10]
            result["breakdown"] = {"device_ops": [list(o) for o in ops],
                                   "idle_gaps": _gaps(dtrace, out)}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return result, checks, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches(ROOT)
    import torch

    from benchmark.cells import load_cell

    chips = load_cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks, out = run_cell(
        ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
        "cuda:0", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print("rounds_ms " + " ".join(f"{x * 1e3:.1f}" for x in out.round_s),
          file=sys.stderr)
    print(f"window_s {out.t1 - out.t0!r} rounds {out.rounds}",
          file=sys.stderr)
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
