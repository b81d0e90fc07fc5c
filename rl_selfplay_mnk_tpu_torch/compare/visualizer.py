"""Tournament charts (counterpart of the JAX package's
``compare/visualizer.py``): ELO against training iteration, one line a run.

``elo_progression.html`` is a self-contained SVG + JavaScript page (hover
crosshair, a tooltip with each point's W/D/L record, click-to-toggle
legend), the JAX package's page built from the same data: the rating rows
that ``compare.elo.ELOTracker.calculate_ratings`` returns, grouped by run
in sorted order and by iteration within a run, with no pandas.
``elo_progression.png`` is the matplotlib chart, written where matplotlib
imports (the package does not depend on it).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

# Categorical palette in a fixed slot order; series past 8 fold to a gray
# with a dash (the JAX package's).
_SERIES = [
    "#2a78d6", "#eb6834", "#1baf7a", "#eda100",
    "#e87ba4", "#008300", "#4a3aa7", "#e34948",
]
_FOLD = "#6b7280"

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>ELO progression</title>
<style>
 body {{ font: 13px/1.4 system-ui, sans-serif; color: #1f2430; margin: 24px;
        background: #fff; }}
 h1 {{ font-size: 16px; font-weight: 600; }}
 .legend {{ display: flex; flex-wrap: wrap; gap: 12px; margin: 8px 0; }}
 .legend span {{ cursor: pointer; display: inline-flex; align-items: center;
                gap: 5px; color: #444c5e; user-select: none; }}
 .legend span.off {{ opacity: 0.3; }}
 .legend i {{ width: 14px; height: 3px; display: inline-block; }}
 #tip {{ position: fixed; pointer-events: none; background: #fff;
        border: 1px solid #d4d8e1; border-radius: 4px; padding: 6px 9px;
        box-shadow: 0 2px 8px rgba(16,24,40,.12); display: none;
        font-size: 12px; }}
 #tip b {{ color: #1f2430; }}
 #tip .muted {{ color: #6b7280; }}
 svg text {{ fill: #6b7280; font-size: 11px; }}
 svg .axis {{ stroke: #d4d8e1; }}
 svg .grid {{ stroke: #eef0f4; }}
 svg .xh {{ stroke: #9aa1b1; stroke-dasharray: 3 3; }}
</style></head><body>
<h1>ELO rating progression</h1>
<div class="legend" id="legend"></div>
<svg id="chart" width="920" height="520"></svg>
<div id="tip"></div>
<script>
const DATA = {data_json};
const PAL = {palette_json};
const M = {{l: 56, r: 16, t: 12, b: 36}};
const svg = document.getElementById("chart");
const W = +svg.getAttribute("width"), H = +svg.getAttribute("height");
const hidden = new Set();
const xs = DATA.flatMap(s => s.points.map(p => p.iteration));
const ys = DATA.flatMap(s => s.points.map(p => p.rating));
const xmin = Math.min(...xs), xmax = Math.max(...xs);
const yspan = Math.max(...ys) - Math.min(...ys) || 1;
const ymin = Math.min(...ys) - 0.06 * yspan, ymax = Math.max(...ys) + 0.06 * yspan;
const X = v => M.l + (xmax === xmin ? 0.5 : (v - xmin) / (xmax - xmin)) * (W - M.l - M.r);
const Y = v => H - M.b - (v - ymin) / (ymax - ymin) * (H - M.t - M.b);
function el(n, a) {{
  const e = document.createElementNS("http://www.w3.org/2000/svg", n);
  for (const k in a) e.setAttribute(k, a[k]);
  svg.appendChild(e); return e;
}}
function ticks(lo, hi, n) {{
  const step = Math.pow(10, Math.floor(Math.log10((hi - lo) / n || 1)));
  const s = [1, 2, 5, 10].map(m => m * step).find(s => (hi - lo) / s <= n) || step;
  const out = []; for (let v = Math.ceil(lo / s) * s; v <= hi; v += s) out.push(v);
  return out;
}}
function draw() {{
  svg.innerHTML = "";
  for (const v of ticks(ymin, ymax, 6)) {{
    el("line", {{x1: M.l, x2: W - M.r, y1: Y(v), y2: Y(v), class: "grid"}});
    const t = el("text", {{x: M.l - 8, y: Y(v) + 4, "text-anchor": "end"}});
    t.textContent = Math.round(v);
  }}
  for (const v of ticks(xmin, xmax, 8)) {{
    const t = el("text", {{x: X(v), y: H - M.b + 18, "text-anchor": "middle"}});
    t.textContent = v;
  }}
  el("line", {{x1: M.l, x2: W - M.r, y1: H - M.b, y2: H - M.b, class: "axis"}});
  const xl = el("text", {{x: (M.l + W - M.r) / 2, y: H - 6, "text-anchor": "middle"}});
  xl.textContent = "Training iteration";
  const yl = el("text", {{x: 14, y: (M.t + H - M.b) / 2, "text-anchor": "middle",
                         transform: `rotate(-90 14 ${{(M.t + H - M.b) / 2}})`}});
  yl.textContent = "ELO rating";
  DATA.forEach((s, i) => {{
    if (hidden.has(i)) return;
    const pts = s.points.map(p => `${{X(p.iteration)}},${{Y(p.rating)}}`).join(" ");
    el("polyline", {{points: pts, fill: "none", stroke: PAL[i % PAL.length].c,
                    "stroke-width": 2, "stroke-dasharray": PAL[i % PAL.length].d}});
    for (const p of s.points)
      el("circle", {{cx: X(p.iteration), cy: Y(p.rating), r: 3.5,
                    fill: PAL[i % PAL.length].c, stroke: "#fff", "stroke-width": 1}});
  }});
}}
const legend = document.getElementById("legend");
DATA.forEach((s, i) => {{
  const sp = document.createElement("span");
  const sw = document.createElement("i");
  sw.style.background = PAL[i % PAL.length].c;
  sp.appendChild(sw); sp.appendChild(document.createTextNode(s.run));
  sp.onclick = () => {{
    hidden.has(i) ? hidden.delete(i) : hidden.add(i);
    sp.classList.toggle("off"); draw();
  }};
  legend.appendChild(sp);
}});
const tip = document.getElementById("tip");
svg.addEventListener("mousemove", ev => {{
  const r = svg.getBoundingClientRect();
  const mx = ev.clientX - r.left, my = ev.clientY - r.top;
  let best = null, bd = 1e9;
  DATA.forEach((s, i) => {{
    if (hidden.has(i)) return;
    for (const p of s.points) {{
      const d = Math.hypot(X(p.iteration) - mx, Y(p.rating) - my);
      if (d < bd) {{ bd = d; best = {{s, p, i}}; }}
    }}
  }});
  [...svg.querySelectorAll(".xh")].forEach(n => n.remove());
  if (!best || bd > 40) {{ tip.style.display = "none"; return; }}
  el("line", {{x1: X(best.p.iteration), x2: X(best.p.iteration),
              y1: M.t, y2: H - M.b, class: "xh"}});
  tip.innerHTML = `<b>${{best.s.run}}</b><br>` +
    `iteration ${{best.p.iteration}} &middot; ELO <b>${{best.p.rating}}</b><br>` +
    `<span class="muted">${{best.p.wins}}W / ${{best.p.draws}}D / ` +
    `${{best.p.losses}}L &middot; win rate ${{(100 * best.p.win_rate).toFixed(1)}}%</span>`;
  tip.style.display = "block";
  tip.style.left = (ev.clientX + 14) + "px";
  tip.style.top = (ev.clientY + 14) + "px";
}});
svg.addEventListener("mouseleave", () => {{ tip.style.display = "none";
  [...svg.querySelectorAll(".xh")].forEach(n => n.remove()); }});
draw();
</script></body></html>
"""


class ResultsVisualizer:
    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)

    def create_all_visualizations(self, ratings: Sequence[Dict]) -> None:
        if not ratings:
            return
        self.plot_elo_progression(ratings)

    @staticmethod
    def series(ratings: Sequence[Dict]) -> List[Tuple[str, List[Dict]]]:
        """[(run name, its rows by iteration)], runs in sorted order (the
        order of pandas' ``groupby``)."""
        runs: Dict = {}
        for row in ratings:
            runs.setdefault(row["run_name"], []).append(row)
        return [(str(run), sorted(runs[run], key=lambda r: r["iteration"]))
                for run in sorted(runs)]

    def plot_elo_progression(self, ratings: Sequence[Dict]) -> str:
        """The HTML page, and the PNG where matplotlib imports; returns the
        HTML's path."""
        series = self.series(ratings)
        self._write_png(series)
        return self._write_interactive_html(series)

    def _write_png(self, series) -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return

        fig, ax = plt.subplots(figsize=(10, 6))
        for i, (run_name, rows) in enumerate(series):
            color = _SERIES[i] if i < len(_SERIES) else _FOLD
            dash = "-" if i < len(_SERIES) else ["--", ":", "-."][i % 3]
            ax.plot([r["iteration"] for r in rows], [r["rating"] for r in rows],
                    dash, color=color, marker="o", markersize=4, label=run_name)
        ax.set_xlabel("Training iteration")
        ax.set_ylabel("ELO rating")
        ax.set_title("ELO rating progression")
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=8)
        fig.tight_layout()
        fig.savefig(os.path.join(self.output_dir, "elo_progression.png"), dpi=150)
        plt.close(fig)

    def _write_interactive_html(self, series) -> str:
        data = [
            {
                "run": run_name,
                "points": [
                    {
                        "iteration": int(r["iteration"]),
                        "rating": float(r["rating"]),
                        "wins": int(r.get("wins", 0)),
                        "draws": int(r.get("draws", 0)),
                        "losses": int(r.get("losses", 0)),
                        "win_rate": float(r.get("win_rate", 0.0)),
                    }
                    for r in rows
                ],
            }
            for run_name, rows in series
        ]
        palette = [
            {"c": _SERIES[i], "d": "none"} if i < len(_SERIES)
            else {"c": _FOLD, "d": ["6 3", "2 3", "8 3 2 3"][i % 3]}
            for i in range(max(1, len(data)))
        ]
        html_path = os.path.join(self.output_dir, "elo_progression.html")
        with open(html_path, "w") as f:
            f.write(_HTML_TEMPLATE.format(data_json=json.dumps(data),
                                          palette_json=json.dumps(palette)))
        return html_path
