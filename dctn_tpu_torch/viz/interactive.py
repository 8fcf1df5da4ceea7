"""Interactive training-curve dashboard (a copy of
``dctn_tpu/viz/interactive.py``) — the Bokeh-grade analog of the
reference's ``plot_training.py:25-239`` (linked range sliders, hover with
values, per-experiment config panes), built with ZERO dependencies: one
standalone HTML file with inline JavaScript + <canvas> rendering of the
embedded record data (neither bokeh nor plotly exists in this environment,
and the output must be a self-contained file like the reference's).

Features (parity + beyond the static matplotlib renderer):
- three figures: val-acc vs train-acc, accuracies vs iterations, mean-CE vs
  iterations (log y) — the reference's figure set;
- a LINKED iteration-range slider: both iteration figures rescale together
  (the reference's linked range sliders);
- hover tooltips with experiment name + exact values at the nearest point;
- click-to-toggle legend entries (hide/show an experiment everywhere);
- per-experiment run_info config panes, shown on legend hover/click.
"""

from __future__ import annotations

import html
import json
import os
from typing import Dict

from .log_parsing import load_records

_PALETTE = [
    "#4269d0", "#efb118", "#ff725c", "#6cc5b0", "#3ca951",
    "#ff8ab7", "#a463f2", "#97bbf5", "#9c6b4e", "#9498a0",
]

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
body { font-family: system-ui, sans-serif; margin: 16px; background: #fafafa; }
h1 { font-size: 18px; }
.row { display: flex; flex-wrap: wrap; gap: 16px; }
.fig { background: #fff; border: 1px solid #ddd; border-radius: 6px;
       padding: 8px; position: relative; }
.fig h2 { font-size: 13px; margin: 2px 0 6px 4px; font-weight: 600; }
canvas { display: block; }
#legend { margin: 12px 0; }
.key { display: inline-flex; align-items: center; margin-right: 14px;
       cursor: pointer; font-size: 12px; user-select: none; }
.key.off { opacity: 0.3; }
.key .swatch { width: 12px; height: 12px; border-radius: 2px;
               display: inline-block; margin-right: 5px; }
#tooltip { position: fixed; pointer-events: none; background: #222;
           color: #fff; font-size: 11px; padding: 4px 7px; border-radius: 4px;
           display: none; z-index: 10; white-space: pre; }
#slider-row { margin: 10px 4px; font-size: 12px; }
#slider-row input { width: 320px; vertical-align: middle; }
.config { background: #fff; border: 1px solid #ddd; border-radius: 6px;
          padding: 8px; font-size: 11px; white-space: pre-wrap; display: none;
          max-width: 640px; max-height: 300px; overflow: auto; }
.config.show { display: block; }
.config h3 { margin: 0 0 4px; font-size: 12px; }
</style></head><body>
<h1>__TITLE__</h1>
<div id="legend"></div>
<div id="slider-row">
  iteration range:
  <input type="range" id="lo" min="0" max="1000" value="0">
  <input type="range" id="hi" min="0" max="1000" value="1000">
  <span id="range-label"></span>
</div>
<div class="row">
  <div class="fig"><h2>val acc vs train acc</h2>
    <canvas id="c0" width="460" height="360"></canvas></div>
  <div class="fig"><h2>accuracy vs iterations (solid: val, dashed: train)</h2>
    <canvas id="c1" width="460" height="360"></canvas></div>
  <div class="fig"><h2>mean CE vs iterations (log y; solid: val, dashed: train)</h2>
    <canvas id="c2" width="460" height="360"></canvas></div>
</div>
<div id="configs"></div>
<div id="tooltip"></div>
<script>
const DATA = __DATA__;
const names = Object.keys(DATA.experiments);
const visible = {}; names.forEach(n => visible[n] = true);
let itLo = DATA.it_min, itHi = DATA.it_max;

function recs(n) { return DATA.experiments[n].records; }

// ---- legend + config panes
const legend = document.getElementById("legend");
const configs = document.getElementById("configs");
names.forEach((n, i) => {
  const k = document.createElement("span");
  k.className = "key";
  k.innerHTML = `<span class="swatch" style="background:${DATA.colors[i]}"></span>${n}`;
  k.onclick = () => { visible[n] = !visible[n];
    k.classList.toggle("off", !visible[n]); drawAll(); };
  k.onmouseenter = () => showConfig(n, true);
  k.onmouseleave = () => showConfig(n, false);
  legend.appendChild(k);
  const c = document.createElement("div");
  c.className = "config"; c.id = "cfg-" + n;
  c.innerHTML = `<h3>${n} — run_info</h3>` +
    (DATA.experiments[n].info || "(no run_info.txt)");
  configs.appendChild(c);
});
function showConfig(n, on) {
  document.getElementById("cfg-" + n).classList.toggle("show", on);
}

// ---- linked iteration sliders
const lo = document.getElementById("lo"), hi = document.getElementById("hi");
function sliderIt(v) {
  return DATA.it_min + (DATA.it_max - DATA.it_min) * v / 1000;
}
function onSlide() {
  itLo = sliderIt(Math.min(+lo.value, +hi.value));
  itHi = sliderIt(Math.max(+lo.value, +hi.value));
  document.getElementById("range-label").textContent =
    `[${Math.round(itLo)}, ${Math.round(itHi)}]`;
  drawAll();
}
lo.oninput = onSlide; hi.oninput = onSlide;

// ---- plotting core
const M = {l: 48, r: 10, t: 8, b: 30};
function makeScale(lo_, hi_, a, b, log) {
  if (log) { lo_ = Math.log10(lo_); hi_ = Math.log10(hi_); }
  const d = (hi_ - lo_) || 1;
  return v => { if (log) v = Math.log10(v); return a + (v - lo_) / d * (b - a); };
}
function axes(ctx, W, H, xlo, xhi, ylo, yhi, logy) {
  ctx.strokeStyle = "#ccc"; ctx.fillStyle = "#555"; ctx.font = "10px sans-serif";
  ctx.strokeRect(M.l, M.t, W - M.l - M.r, H - M.t - M.b);
  for (let i = 0; i <= 4; i++) {
    const fx = xlo + (xhi - xlo) * i / 4;
    const px = M.l + (W - M.l - M.r) * i / 4;
    ctx.fillText(fx.toPrecision(4), px - 12, H - M.b + 14);
    let fy, label;
    if (logy) { fy = Math.log10(ylo) + (Math.log10(yhi) - Math.log10(ylo)) * i / 4;
                label = Math.pow(10, fy).toPrecision(3); }
    else { fy = ylo + (yhi - ylo) * i / 4; label = fy.toPrecision(4); }
    const py = H - M.b - (H - M.t - M.b) * i / 4;
    ctx.fillText(label, 4, py + 3);
  }
}
const hoverPts = {c0: [], c1: [], c2: []};
function series(ctx, id, pts, color, dashed, label, sx, sy) {
  if (!pts.length) return;
  ctx.strokeStyle = color; ctx.fillStyle = color;
  ctx.setLineDash(dashed ? [5, 3] : []);
  ctx.beginPath();
  pts.forEach((p, i) => {
    const X = sx(p.x), Y = sy(p.y);
    if (i === 0) ctx.moveTo(X, Y); else ctx.lineTo(X, Y);
    hoverPts[id].push({X, Y, tip: label + "\\n" + p.tip});
  });
  ctx.stroke(); ctx.setLineDash([]);
  pts.forEach(p => { ctx.beginPath();
    ctx.arc(sx(p.x), sy(p.y), 2.1, 0, 6.3); ctx.fill(); });
}
function inRange(r) { return r.nitd >= itLo && r.nitd <= itHi; }

function drawFig(id, build, logy) {
  const cv = document.getElementById(id), ctx = cv.getContext("2d");
  ctx.clearRect(0, 0, cv.width, cv.height);
  hoverPts[id] = [];
  const all = [];
  names.forEach((n, i) => { if (visible[n]) all.push(...build(n).pts); });
  if (!all.length) return;
  let xlo = Math.min(...all.map(p => p.x)), xhi = Math.max(...all.map(p => p.x));
  let ylo = Math.min(...all.map(p => p.y)), yhi = Math.max(...all.map(p => p.y));
  if (xlo === xhi) { xlo -= 1; xhi += 1; }
  if (ylo === yhi) { ylo = ylo - Math.abs(ylo) * 0.1 - 1e-6;
                     yhi = yhi + Math.abs(yhi) * 0.1 + 1e-6; }
  const sx = makeScale(xlo, xhi, M.l, cv.width - M.r, false);
  const sy = makeScale(ylo, yhi, cv.height - M.b, M.t, logy);
  axes(ctx, cv.width, cv.height, xlo, xhi, ylo, yhi, logy);
  names.forEach((n, i) => {
    if (!visible[n]) return;
    build(n).series.forEach(s =>
      series(ctx, id, s.pts, DATA.colors[i], s.dashed, s.label, sx, sy));
  });
}
function drawAll() {
  drawFig("c0", n => {
    const pts = recs(n).filter(inRange).map(r =>
      ({x: r.tracc, y: r.vacc,
        tip: `tracc=${r.tracc.toFixed(4)} vacc=${r.vacc.toFixed(4)} it=${r.nitd}`}));
    return {pts, series: [{pts, dashed: false, label: n}]};
  }, false);
  drawFig("c1", n => {
    const v = recs(n).filter(inRange).map(r =>
      ({x: r.nitd, y: r.vacc, tip: `vacc=${r.vacc.toFixed(4)} it=${r.nitd}`}));
    const t = recs(n).filter(inRange).map(r =>
      ({x: r.nitd, y: r.tracc, tip: `tracc=${r.tracc.toFixed(4)} it=${r.nitd}`}));
    return {pts: v.concat(t), series: [
      {pts: v, dashed: false, label: n + " (val)"},
      {pts: t, dashed: true, label: n + " (train)"}]};
  }, false);
  drawFig("c2", n => {
    const v = recs(n).filter(inRange).map(r =>
      ({x: r.nitd, y: r.vmce, tip: `vmce=${r.vmce.toExponential(3)} it=${r.nitd}`}));
    const t = recs(n).filter(inRange).map(r =>
      ({x: r.nitd, y: r.trmce, tip: `trmce=${r.trmce.toExponential(3)} it=${r.nitd}`}));
    return {pts: v.concat(t), series: [
      {pts: v, dashed: false, label: n + " (val)"},
      {pts: t, dashed: true, label: n + " (train)"}]};
  }, true);
}

// ---- hover tooltips (nearest point within 12px)
const tooltip = document.getElementById("tooltip");
["c0", "c1", "c2"].forEach(id => {
  const cv = document.getElementById(id);
  cv.onmousemove = e => {
    const r = cv.getBoundingClientRect();
    const x = e.clientX - r.left, y = e.clientY - r.top;
    let best = null, bd = 12 * 12;
    hoverPts[id].forEach(p => {
      const d = (p.X - x) ** 2 + (p.Y - y) ** 2;
      if (d < bd) { bd = d; best = p; }
    });
    if (best) {
      tooltip.style.display = "block";
      tooltip.style.left = (e.clientX + 12) + "px";
      tooltip.style.top = (e.clientY + 12) + "px";
      tooltip.textContent = best.tip;
    } else tooltip.style.display = "none";
  };
  cv.onmouseleave = () => tooltip.style.display = "none";
});

onSlide();
</script></body></html>
"""


def render_interactive_dashboard(
    plot_config: Dict,
    output_html: str,
    increasing_tracc: bool = False,
) -> None:
    """``plot_config``: {"experiments": {name: dir, ...}, "title": ...} —
    the same schema as the static renderer / the config generator."""
    experiments = plot_config["experiments"]
    data = {"experiments": {}, "colors": [], "it_min": 0, "it_max": 1}
    its = []
    for i, (name, exp_dir) in enumerate(experiments.items()):
        log_path = os.path.join(exp_dir, "log.log")
        if not os.path.exists(log_path):
            continue
        records = load_records(log_path, increasing_tracc)
        info_path = os.path.join(exp_dir, "run_info.txt")
        info = ""
        if os.path.exists(info_path):
            with open(info_path) as f:
                info = html.escape(f.read())
        data["experiments"][name] = {
            "records": [
                {
                    "nitd": r.nitd,
                    "tracc": r.tracc,
                    "vacc": r.vacc,
                    "trmce": r.trmce,
                    "vmce": r.vmce,
                }
                for r in records
            ],
            "info": info,
        }
        its += [r.nitd for r in records]
        data["colors"].append(_PALETTE[i % len(_PALETTE)])
    if its:
        data["it_min"], data["it_max"] = min(its), max(its)
    page = _PAGE.replace(
        "__TITLE__", html.escape(str(plot_config.get("title", "training")))
    ).replace("__DATA__", json.dumps(data))
    with open(output_html, "w") as f:
        f.write(page)
