"""Web job board — the FATEBoard analogue, served by the job server (port
of flashe_tpu/runtime/webboard.py, which needs no JAX; the port keeps its
own copy, page for page the same HTML).

FATEBoard (absent git submodule in the reference) is a Java web dashboard
over fate_flow's tracking DB.  Here the job server (runtime/server.py)
serves the same views as dependency-free HTML:

    GET /            -> job list (links to per-job boards)
    GET /board/<id>  -> one job: status, tasks, loss curve, evaluation
                        metrics, phase profile, transfer stats

Rendering is server-side (stdlib only); the loss chart is inline SVG with
a small hover layer (crosshair + tooltip).  Pages auto-refresh while the
job runs.  Colors are the pre-validated reference dataviz palette
(categorical slots 1-3 all-pairs safe in light and dark; status colors
always paired with a text label, never color alone).
"""

from __future__ import annotations

import html
import json
import time
from typing import Dict, List, Optional

__all__ = ["render_index_html", "render_job_html"]

# reference dataviz palette (light, dark) — series slots 1-3 only
_SERIES = [("#2a78d6", "#3987e5"), ("#eb6834", "#d95926"),
           ("#1baf7a", "#199e70")]
_STATUS = {  # color + glyph; the word itself always renders beside it
    "success": ("#0ca30c", "#0ca30c"),
    "running": ("#2a78d6", "#3987e5"),
    "waiting": ("#898781", "#898781"),
    "failed": ("#d03b3b", "#d03b3b"),
    "timeout": ("#d03b3b", "#d03b3b"),
    "canceled": ("#898781", "#898781"),
}

_CSS = """
:root { color-scheme: light dark; }
body {
  margin: 0; padding: 24px;
  background: #f9f9f7; color: #0b0b0b;
  font: 14px/1.45 system-ui, -apple-system, "Segoe UI", sans-serif;
  --surface: #fcfcfb; --ink: #0b0b0b; --ink2: #52514e; --muted: #898781;
  --grid: #e1e0d9; --axis: #c3c2b7; --border: rgba(11,11,11,0.10);
}
@media (prefers-color-scheme: dark) {
  body {
    background: #0d0d0d; color: #ffffff;
    --surface: #1a1a19; --ink: #ffffff; --ink2: #c3c2b7; --muted: #898781;
    --grid: #2c2c2a; --axis: #383835; --border: rgba(255,255,255,0.10);
  }
}
h1 { font-size: 18px; font-weight: 600; margin: 0 0 4px; }
h2 { font-size: 13px; font-weight: 600; color: var(--ink2);
     margin: 0 0 8px; text-transform: uppercase; letter-spacing: .04em; }
a { color: inherit; }
.card { background: var(--surface); border: 1px solid var(--border);
        border-radius: 8px; padding: 16px 18px; margin: 0 0 16px;
        max-width: 860px; }
.sub { color: var(--ink2); margin: 0 0 16px; }
table { border-collapse: collapse; width: 100%; }
th { text-align: left; color: var(--muted); font-weight: 500;
     padding: 4px 14px 4px 0; border-bottom: 1px solid var(--grid); }
td { padding: 5px 14px 5px 0; border-bottom: 1px solid var(--grid);
     font-variant-numeric: tabular-nums; }
tr:last-child td { border-bottom: none; }
.status { font-weight: 600; white-space: nowrap; }
.dot { display: inline-block; width: 8px; height: 8px;
       border-radius: 50%; margin-right: 6px; vertical-align: baseline; }
.bar-row { display: grid; grid-template-columns: 150px 1fr 90px;
           align-items: center; gap: 10px; margin: 0 0 2px; }
.bar-label { color: var(--ink2); text-align: right;
             overflow: hidden; text-overflow: ellipsis;
             white-space: nowrap; }
.bar-track { position: relative; height: 16px; }
.bar-fill { position: absolute; left: 0; top: 0; bottom: 0;
            background: var(--s1); border-radius: 0 4px 4px 0; }
.bar-val { color: var(--ink2); font-variant-numeric: tabular-nums; }
.chart-wrap { position: relative; }
.tip { position: absolute; display: none; pointer-events: none;
       background: var(--surface); border: 1px solid var(--border);
       border-radius: 6px; padding: 6px 9px; font-size: 12px;
       box-shadow: 0 2px 8px rgba(0,0,0,.12); white-space: nowrap; }
.tip b { font-variant-numeric: tabular-nums; }
.tip .k { color: var(--ink2); }
.key { display: inline-block; width: 14px; height: 0;
       border-top: 2px solid; vertical-align: middle; margin-right: 5px; }
details summary { color: var(--ink2); cursor: pointer; margin-top: 8px; }
.legend { color: var(--ink2); font-size: 12px; margin: 2px 0 0; }
.legend span { margin-right: 14px; }
"""

_CHART_JS = """
(function () {
  document.querySelectorAll('.chart-wrap').forEach(function (wrap) {
    var data = JSON.parse(wrap.querySelector('script').textContent);
    var svg = wrap.querySelector('svg');
    var cross = svg.querySelector('.cross');
    var tip = wrap.querySelector('.tip');
    var g = data.geom;
    function show(evt) {
      var pt = svg.createSVGPoint();
      pt.x = evt.clientX; pt.y = evt.clientY;
      var p = pt.matrixTransform(svg.getScreenCTM().inverse());
      var n = 0;
      data.series.forEach(function (s) {
        n = Math.max(n, s.values.length);
      });
      if (n < 1) return;
      var frac = (p.x - g.x0) / (g.x1 - g.x0);
      var i = Math.round(frac * (n - 1));
      i = Math.max(0, Math.min(n - 1, i));
      var x = n === 1 ? (g.x0 + g.x1) / 2
                      : g.x0 + (g.x1 - g.x0) * i / (n - 1);
      cross.setAttribute('x1', x); cross.setAttribute('x2', x);
      cross.style.display = 'block';
      while (tip.firstChild) tip.removeChild(tip.firstChild);
      var head = document.createElement('div');
      head.className = 'k';
      head.textContent = 'round ' + (i + 1);
      tip.appendChild(head);
      data.series.forEach(function (s) {
        var row = document.createElement('div');
        var key = document.createElement('span');
        key.className = 'key';
        key.style.borderTopColor = s.color;
        var val = document.createElement('b');
        val.textContent = s.values[i] == null ? '-'
          : Number(s.values[i]).toFixed(4);
        var name = document.createElement('span');
        name.className = 'k';
        name.textContent = ' ' + s.name;
        row.appendChild(key); row.appendChild(val);
        row.appendChild(name);
        tip.appendChild(row);
      });
      tip.style.display = 'block';
      var box = wrap.getBoundingClientRect();
      var left = evt.clientX - box.left + 14;
      if (left + tip.offsetWidth > box.width - 4)
        left = evt.clientX - box.left - tip.offsetWidth - 14;
      tip.style.left = left + 'px';
      tip.style.top = Math.max(0, evt.clientY - box.top - 18) + 'px';
    }
    function hide() {
      cross.style.display = 'none'; tip.style.display = 'none';
    }
    svg.addEventListener('pointermove', show);
    svg.addEventListener('pointerleave', hide);
  });
})();
"""


def _esc(v) -> str:
    return html.escape(str(v), quote=True)


def _page(title: str, body: str, refresh: bool = False) -> str:
    meta = ('<meta http-equiv="refresh" content="5">' if refresh else "")
    return (f"<!doctype html><html><head><meta charset='utf-8'>{meta}"
            f"<meta name='viewport' content='width=device-width,"
            f"initial-scale=1'><title>{_esc(title)}</title>"
            f"<style>{_CSS}</style></head><body>{body}"
            f"<script>{_CHART_JS}</script></body></html>")


def _status_html(status: str) -> str:
    light, dark = _STATUS.get(status, ("#898781", "#898781"))
    return (f"<span class='status'><span class='dot' style='background:"
            f"light-dark({light},{dark})'></span>{_esc(status)}</span>")


def _fmt_age(ts: Optional[float]) -> str:
    if not ts:
        return "-"
    dt = max(0.0, time.time() - float(ts))
    if dt < 120:
        return f"{dt:.0f}s ago"
    if dt < 7200:
        return f"{dt / 60:.0f}m ago"
    return f"{dt / 3600:.1f}h ago"


# --------------------------------------------------------------------- index


def render_index_html(jobs: List[dict],
                      queue: Optional[dict] = None) -> str:
    rows = []
    for rec in sorted(jobs, key=lambda r: r.get("created") or 0,
                      reverse=True):
        jid = _esc(rec["job_id"])
        rows.append(
            f"<tr><td><a href='/board/{jid}'>{jid}</a></td>"
            f"<td>{_status_html(rec.get('status', '?'))}</td>"
            f"<td>{len(rec.get('tasks', {}))}</td>"
            f"<td>{_esc(_fmt_age(rec.get('updated')))}</td></tr>")
    table = ("<table><tr><th>job</th><th>status</th><th>tasks</th>"
             "<th>updated</th></tr>" + "".join(rows) + "</table>"
             if rows else "<p class='sub'>no jobs yet</p>")
    running = any(r.get("status") in ("running", "waiting")
                  for r in jobs)
    qline = ""
    if queue is not None:
        qline = (f" &nbsp;&middot;&nbsp; queue: "
                 f"{len(queue.get('running', []))} running / "
                 f"{len(queue.get('waiting', []))} waiting "
                 f"(max {queue.get('max_concurrent', '?')} concurrent)")
    body = (f"<h1>flashe-tpu jobs</h1><p class='sub'>{len(jobs)} job(s)"
            f"{qline}</p><div class='card'>{table}</div>")
    return _page("flashe-tpu jobs", body, refresh=running)


# ---------------------------------------------------------------- loss chart


def _loss_chart(series: Dict[str, List[float]]) -> str:
    """Inline-SVG line chart (2px lines, end markers with surface ring,
    hairline grid) + crosshair/tooltip hover layer + table fallback."""
    names = sorted(series)[:3]  # ≥4 series would need small multiples
    W, H = 720, 240
    x0, x1, y0, y1 = 52, W - 16, 14, H - 30
    vals = [v for n in names for v in series[n] if v is not None]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi - lo < 1e-12:
        lo, hi = lo - 0.5, hi + 0.5
    pad = (hi - lo) * 0.06
    lo, hi = lo - pad, hi + pad
    n_max = max(len(series[n]) for n in names)

    def sx(i):
        return (x0 + x1) / 2 if n_max == 1 else \
            x0 + (x1 - x0) * i / (n_max - 1)

    def sy(v):
        return y1 - (y1 - y0) * (v - lo) / (hi - lo)

    parts = [f"<svg viewBox='0 0 {W} {H}' role='img' "
             f"aria-label='loss per aggregation round' "
             f"style='width:100%;height:auto;display:block'>"]
    # hairline grid + y ticks (4 clean steps)
    for k in range(5):
        v = lo + (hi - lo) * k / 4
        y = sy(v)
        parts.append(f"<line x1='{x0}' y1='{y:.1f}' x2='{x1}' "
                     f"y2='{y:.1f}' stroke='var(--grid)' "
                     f"stroke-width='1'/>")
        parts.append(f"<text x='{x0 - 8}' y='{y + 4:.1f}' "
                     f"text-anchor='end' font-size='11' "
                     f"fill='var(--muted)' style='font-variant-numeric:"
                     f"tabular-nums'>{v:.3f}</text>")
    # x axis baseline + round ticks
    parts.append(f"<line x1='{x0}' y1='{y1}' x2='{x1}' y2='{y1}' "
                 f"stroke='var(--axis)' stroke-width='1'/>")
    step = max(1, (n_max - 1) // 8 or 1)
    for i in range(0, n_max, step):
        parts.append(f"<text x='{sx(i):.1f}' y='{H - 10}' "
                     f"text-anchor='middle' font-size='11' "
                     f"fill='var(--muted)'>{i + 1}</text>")
    # series lines + end markers (2px surface ring via paint order)
    payload = {"series": [], "geom": {"x0": x0, "x1": x1}}
    for si, name in enumerate(names):
        light, dark = _SERIES[si % len(_SERIES)]
        color = f"light-dark({light},{dark})"
        pts = [(sx(i), sy(v)) for i, v in enumerate(series[name])
               if v is not None]
        d = "M" + " L".join(f"{x:.1f},{y:.1f}" for x, y in pts)
        parts.append(f"<path d='{d}' fill='none' stroke='{color}' "
                     f"stroke-width='2' stroke-linejoin='round' "
                     f"stroke-linecap='round'/>")
        ex, ey = pts[-1]
        parts.append(f"<circle cx='{ex:.1f}' cy='{ey:.1f}' r='6' "
                     f"fill='var(--surface)'/>")
        parts.append(f"<circle cx='{ex:.1f}' cy='{ey:.1f}' r='4' "
                     f"fill='{color}'/>")
        # direct label at the line end: final value (selective labeling)
        anchor = "end" if ex > x1 - 60 else "start"
        dx = -10 if anchor == "end" else 10
        parts.append(f"<text x='{ex + dx:.1f}' y='{ey - 8:.1f}' "
                     f"text-anchor='{anchor}' font-size='11' "
                     f"fill='var(--ink2)' style='font-variant-numeric:"
                     f"tabular-nums'>{series[name][-1]:.4f}</text>")
        payload["series"].append({
            "name": name, "color": color,
            "values": [None if v is None else float(v)
                       for v in series[name]]})
    parts.append(f"<line class='cross' x1='0' y1='{y0}' x2='0' "
                 f"y2='{y1}' stroke='var(--axis)' stroke-width='1' "
                 f"style='display:none'/>")
    parts.append("</svg>")
    svg = "".join(parts)

    legend = ""
    if len(names) > 1:  # single series: the section title names it
        keys = []
        for si, name in enumerate(names):
            light, dark = _SERIES[si % len(_SERIES)]
            keys.append(f"<span><span class='key' style='border-top-color:"
                        f"light-dark({light},{dark})'></span>"
                        f"{_esc(name)}</span>")
        legend = f"<p class='legend'>{''.join(keys)}</p>"

    # table view (values reachable without hover)
    head = "".join(f"<th>{_esc(n)}</th>" for n in names)
    trs = []
    for i in range(n_max):
        tds = "".join(
            f"<td>{series[n][i]:.6f}</td>" if i < len(series[n])
            and series[n][i] is not None else "<td>-</td>" for n in names)
        trs.append(f"<tr><td>{i + 1}</td>{tds}</tr>")
    table = (f"<details><summary>table view</summary><table>"
             f"<tr><th>round</th>{head}</tr>{''.join(trs)}</table>"
             f"</details>")

    data = json.dumps(payload)
    return (f"<div class='chart-wrap'>{svg}"
            f"<div class='tip'></div>"
            f"<script type='application/json'>{data}</script></div>"
            f"{legend}{table}")


def _phase_bars(phases: Dict[str, dict]) -> str:
    """Horizontal bars (one series -> one hue), value labels at the tip."""
    items = sorted(phases.items(), key=lambda kv: -kv[1]["total_s"])
    if not items:
        return ""
    top = max(v["total_s"] for _, v in items) or 1.0
    light, dark = _SERIES[0]
    rows = []
    for name, stat in items:
        w = max(0.5, 100.0 * stat["total_s"] / top)
        rows.append(
            f"<div class='bar-row'><span class='bar-label'>{_esc(name)}"
            f"</span><span class='bar-track'><span class='bar-fill' "
            f"style='width:{w:.1f}%;--s1:light-dark({light},{dark})'>"
            f"</span></span><span class='bar-val'>"
            f"{stat['total_s']:.3f}s &times;{stat['count']}</span></div>")
    return "".join(rows)


# ----------------------------------------------------------------- job page


def _dag_card(dag: dict) -> str:
    """Pipeline DAG card (tracking/pipeline app view — runtime/apps.py
    dag_dependency; FATEBoard renders the same dependency graph)."""
    mods = dag.get("component_module", {})
    deps = dag.get("dependencies", {})
    rows = "".join(
        f"<tr><td>{_esc(c)}</td><td>{_esc(mods.get(c, ''))}</td>"
        f"<td>{_esc(', '.join(deps.get(c, [])) or '-')}</td></tr>"
        for c in dag.get("component_list", []))
    return (f"<div class='card'><h2>pipeline DAG</h2><table>"
            f"<tr><th>component</th><th>module</th><th>depends on</th>"
            f"</tr>{rows}</table></div>")


def _metrics_card(metrics: dict) -> str:
    """Tracked metric series (tracking app view — apps.metric_all)."""
    rows = []
    for rk, comps in sorted(metrics.items()):
        for comp, series in sorted(comps.items()):
            for name, pts in sorted(series.items()):
                last = f"{pts[-1][1]:.6g}" if pts else "-"
                rows.append(
                    f"<tr><td>{_esc(rk)}/{_esc(comp)}</td>"
                    f"<td>{_esc(name)}</td><td>{len(pts)}</td>"
                    f"<td>{_esc(last)}</td></tr>")
    if not rows:
        return ""
    return (f"<div class='card'><h2>tracked metrics</h2><table>"
            f"<tr><th>component</th><th>metric</th><th>points</th>"
            f"<th>last</th></tr>{''.join(rows)}</table></div>")


def render_job_html(rec: dict, result: Optional[dict] = None,
                    tracking: Optional[dict] = None) -> str:
    jid = rec["job_id"]
    summary = (result or {}).get("result") or {}
    tracking = tracking or {}

    cards = []
    err = (f"<p class='sub'>error: {_esc(rec['error'])}</p>"
           if rec.get("error") else "")
    cards.append(
        f"<div class='card'><h1>job {_esc(jid)}</h1>"
        f"<p class='sub'>{_status_html(rec.get('status', '?'))}"
        f" &nbsp;&middot;&nbsp; created {_esc(_fmt_age(rec.get('created')))}"
        f" &nbsp;&middot;&nbsp; updated {_esc(_fmt_age(rec.get('updated')))}"
        f"</p>{err}</div>")

    tasks = rec.get("tasks", {})
    if tasks:
        rows = "".join(
            f"<tr><td>{_esc(name)}</td>"
            f"<td>{_status_html(t.get('status', 'running'))}</td>"
            f"<td>{_esc(t.get('pid', '-'))}</td></tr>"
            for name, t in sorted(tasks.items()))
        cards.append(f"<div class='card'><h2>tasks</h2><table>"
                     f"<tr><th>task</th><th>status</th><th>pid</th></tr>"
                     f"{rows}</table></div>")

    if tracking.get("dag"):
        cards.append(_dag_card(tracking["dag"]))
    if tracking.get("metrics"):
        card = _metrics_card(tracking["metrics"])
        if card:
            cards.append(card)

    # loss curves: {series name -> values}
    series: Dict[str, List[float]] = {}
    for role_key, role_out in sorted(summary.items()):
        if not isinstance(role_out, dict):
            continue
        if "loss_history" in role_out:
            series[role_key] = role_out["loss_history"]
        for comp, val in sorted(role_out.items()):
            if isinstance(val, dict) and val.get("loss_history"):
                series[f"{role_key}/{comp}"] = val["loss_history"]
    if series:
        cards.append(f"<div class='card'><h2>loss per round</h2>"
                     f"{_loss_chart(series)}</div>")

    # evaluation metrics
    eval_rows = []
    for role_key, role_out in sorted(summary.items()):
        if not isinstance(role_out, dict):
            continue
        for comp, val in sorted(role_out.items()):
            if isinstance(val, dict) and "accuracy" in val:
                metrics = "".join(
                    f"<td>{v:.4f}</td>" for k, v in sorted(val.items())
                    if isinstance(v, float))
                headers = "".join(
                    f"<th>{_esc(k)}</th>" for k, v in sorted(val.items())
                    if isinstance(v, float))
                eval_rows.append(
                    f"<table><tr><th>component</th>{headers}</tr>"
                    f"<tr><td>{_esc(role_key)}/{_esc(comp)}</td>{metrics}"
                    f"</tr></table>")
    if eval_rows:
        cards.append(f"<div class='card'><h2>evaluation</h2>"
                     f"{''.join(eval_rows)}</div>")

    # phase profile (first role that has one, guest preferred)
    for role_key in sorted(summary, key=lambda k: (not k.startswith("g"),
                                                   k)):
        role_out = summary[role_key]
        if isinstance(role_out, dict) and role_out.get("phases"):
            cards.append(f"<div class='card'><h2>phase profile "
                         f"[{_esc(role_key)}]</h2>"
                         f"{_phase_bars(role_out['phases'])}</div>")
            break

    # transfer stats
    for role_key in sorted(summary):
        role_out = summary[role_key]
        if isinstance(role_out, dict) and role_out.get("transfer_stats"):
            rows = []
            for var, stat in sorted(role_out["transfer_stats"].items()):
                if not isinstance(stat, dict):
                    continue
                rows.append(
                    f"<tr><td>{_esc(var)}</td>"
                    f"<td>{_esc(stat.get('sent_msgs', 0))}</td>"
                    f"<td>{_esc(stat.get('sent_bytes', 0))}</td>"
                    f"<td>{_esc(stat.get('recv_msgs', 0))}</td>"
                    f"<td>{_esc(stat.get('recv_bytes', 0))}</td></tr>")
            if rows:
                cards.append(
                    f"<div class='card'><h2>transfer "
                    f"[{_esc(role_key)}]</h2><table><tr><th>variable</th>"
                    f"<th>sent</th><th>sent bytes</th><th>recv</th>"
                    f"<th>recv bytes</th></tr>{''.join(rows)}</table>"
                    f"</div>")
            break

    body = ("<p class='sub'><a href='/board'>&larr; all jobs</a></p>"
            + "".join(cards))
    return _page(f"job {jid}", body,
                 refresh=rec.get("status") in ("running", "waiting"))
