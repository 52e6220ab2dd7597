"""One reader a metric, found by the metric's name in BENCHMARK.json: a
file `<name>.py` here (the name may hold dots, as `codec_ms.agg`) with
`read(run) -> float | None`.  A reader that
finds nothing to read returns None, and the metric is left out of the
line.  `run` carries the window's Outcome (drive.py), setup_s and, in a
traced run, the device's records (`trace`, a devtrace.DeviceTrace or None)."""

from __future__ import annotations

import importlib.util
import os

__all__ = ["read", "phase_ms", "mask_bound_s"]


def read(name: str, run):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def phase_ms(run, role: str, names) -> float | None:
    """Milliseconds a window round that `role` spent in the phases
    `names`, or None where it recorded none of them."""
    out = run.out
    spans = [(b, e) for n, b, e in out.spans.get(role, ())
             if n in names and b >= out.t0 and e <= out.t1]
    if not spans:
        return None
    return sum(e - b for b, e in spans) / out.rounds * 1e3


def mask_bound_s(run) -> float | None:
    """The least seconds of the window's mask launches, or None where they
    are not all dense double launches (the only mode whose lane count the
    run knows)."""
    from benchmark import roofline

    launches = run.out.launches
    if any(v for k, v in launches.items() if k != "double"):
        return None
    return launches.get("double", 0) * roofline.mask_bound_s(
        run.out.lanes, run.out.int_bits, 2)
