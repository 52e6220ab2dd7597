"""Terminal job board — the FATEBoard analogue (port of
flashe_tpu/runtime/board.py, which needs no JAX; the port keeps its own
copy).

FATEBoard (absent git submodule in the reference) is a web dashboard over
fate_flow's tracking DB: per-job status, per-task state, loss curves and
metrics.  This module renders the same information as terminal text from
the job registry + summarized results (`python -m flashe_tpu_torch board
-j <job_id>`), keeping the framework dependency-free.
"""

from __future__ import annotations

import time
from typing import Optional

__all__ = ["render_job", "sparkline"]

_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values, width: int = 48) -> str:
    """Unicode sparkline of a numeric series (downsampled to `width`)."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:
        step = len(vals) / width
        vals = [vals[int(i * step)] for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(_BLOCKS[int((v - lo) / span * (len(_BLOCKS) - 1))]
                   for v in vals)


def _fmt_age(ts: Optional[float]) -> str:
    if not ts:
        return "-"
    dt = time.time() - ts
    if dt < 120:
        return f"{dt:.0f}s ago"
    if dt < 7200:
        return f"{dt / 60:.0f}m ago"
    return f"{dt / 3600:.1f}h ago"


def render_job(rec: dict, result: Optional[dict] = None) -> str:
    """Render one job's dashboard: status, tasks, curves, metrics."""
    lines = []
    lines.append(f"job {rec['job_id']}  [{rec['status']}]  "
                 f"created {_fmt_age(rec.get('created'))}  "
                 f"updated {_fmt_age(rec.get('updated'))}")
    if rec.get("error"):
        lines.append(f"  error: {rec['error']}")

    tasks = rec.get("tasks", {})
    if tasks:
        lines.append("tasks:")
        for name, t in sorted(tasks.items()):
            lines.append(f"  {name:<14} {t['status']:<9} pid={t['pid']}")

    summary = (result or {}).get("result") if result else None
    if summary:
        # arbiter loss curve(s)
        for role_key, role_out in sorted(summary.items()):
            if not isinstance(role_out, dict):
                continue
            for comp, val in sorted(role_out.items()):
                if isinstance(val, dict) and "loss_history" in val:
                    hist = val["loss_history"]
                    if hist:
                        lines.append(
                            f"loss {role_key}/{comp}: "
                            f"{hist[0]:.4f} -> {hist[-1]:.4f}")
                        lines.append("  " + sparkline(hist))
        # evaluation metrics
        rows = []
        for role_key, role_out in sorted(summary.items()):
            if not isinstance(role_out, dict):
                continue
            for comp, val in sorted(role_out.items()):
                if isinstance(val, dict) and "accuracy" in val:
                    metrics = "  ".join(
                        f"{k}={v:.4f}" for k, v in sorted(val.items())
                        if isinstance(v, float))
                    rows.append(f"  {role_key}/{comp}: {metrics}")
        if rows:
            lines.append("evaluation:")
            lines.extend(rows)
        # phase profile (guest first)
        for role_key in sorted(summary):
            phases = summary[role_key].get("phases") if isinstance(
                summary[role_key], dict) else None
            if phases:
                lines.append(f"phases [{role_key}]:")
                for name, stat in sorted(phases.items()):
                    lines.append(f"  {name:<18} {stat['total_s']:8.3f}s "
                                 f"x{stat['count']}")
                break
        # transfer stats (one role is representative)
        for role_key in sorted(summary):
            ts = summary[role_key].get("transfer_stats") if isinstance(
                summary[role_key], dict) else None
            if ts:
                lines.append(f"transfer [{role_key}]:")
                for var, stat in sorted(ts.items()):
                    if isinstance(stat, dict):
                        lines.append(f"  {var}: {stat}")
                break
    return "\n".join(lines)
