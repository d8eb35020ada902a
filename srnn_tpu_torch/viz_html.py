"""Self-contained interactive HTML trajectory plots; a copy of
``srnn_tpu/viz_html.py``, with no matplotlib.

The reference's analysis CLI writes *offline plotly HTML* per artifact —
a rotatable 3-D view of per-particle weight-space trajectories
(``visualization.py:119-179``, ``plotly.offline.plot`` to ``.html``).
Plotly is not a dependency, so this module emits a dependency-free HTML
file with a small inline canvas renderer instead: drag to orbit, wheel to
zoom, same visual contract as the reference plot (x/y = PCA components,
z = time, red start / black end markers, one colored line per particle
lifetime).

The file is fully self-contained (data embedded as JSON, no network),
so it opens anywhere — the same property the reference got from
``include_plotlyjs=True`` offline plots.
"""

import html as _html
import json
import os
from typing import Dict, List

import numpy as np

from .viz import extract_pca

# the tab20 cycle of the PNG renderer (matplotlib's ``tab20`` colormap as
# ``to_hex`` writes it; tests/test_torch_viz.py holds the two equal), a
# literal so that this module runs without matplotlib
_PALETTE = (
    "#1f77b4", "#aec7e8", "#ff7f0e", "#ffbb78", "#2ca02c",
    "#98df8a", "#d62728", "#ff9896", "#9467bd", "#c5b0d5",
    "#8c564b", "#c49c94", "#e377c2", "#f7b6d2", "#7f7f7f",
    "#c7c7c7", "#bcbd22", "#dbdb8d", "#17becf", "#9edae5",
)

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>%(title)s</title>
<style>
 body { margin:0; font:13px sans-serif; background:#fff; color:#222; }
 #hud { position:fixed; top:8px; left:10px; user-select:none; }
 canvas { display:block; cursor:grab; }
</style></head>
<body>
<div id="hud"><b>%(title)s</b> &mdash; drag to orbit, wheel to zoom,
double-click to reset. %(n_traj)d trajectories.</div>
<canvas id="c"></canvas>
<script>
const TRAJS = %(data)s;            // [{xyz: [[x,y,z],...], color}]
const AXES = ["PCA 1", "PCA 2", "time"];
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
let yaw = -0.9, pitch = 0.5, zoom = 1.0;
function resize() { cv.width = innerWidth; cv.height = innerHeight; draw(); }
function proj(p) {                 // orthographic orbit camera
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x = p[0] * cy + p[1] * sy;
  const y = -p[0] * sy + p[1] * cy;
  const z = p[2];
  const u = x, v = y * sp + z * cp;         // screen-plane coords
  const s = 0.36 * Math.min(cv.width, cv.height) * zoom;
  return [cv.width / 2 + u * s, cv.height / 2 - v * s];
}
function line(a, b, color, w) {
  ctx.strokeStyle = color; ctx.lineWidth = w;
  ctx.beginPath(); ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]); ctx.stroke();
}
function dot(p, color, r) {
  ctx.fillStyle = color;
  ctx.beginPath(); ctx.arc(p[0], p[1], r, 0, 6.2832); ctx.fill();
}
function draw() {
  ctx.clearRect(0, 0, cv.width, cv.height);
  // unit-box axes frame
  const C = [[-1,-1,-1],[1,-1,-1],[-1,1,-1],[-1,-1,1],[1,1,-1],[1,-1,1],[-1,1,1],[1,1,1]];
  const E = [[0,1],[0,2],[0,3],[1,4],[2,4],[1,5],[3,5],[2,6],[3,6],[4,7],[5,7],[6,7]];
  for (const [i, j] of E) line(proj(C[i]), proj(C[j]), "#ccc", 1);
  ctx.fillStyle = "#666";
  ctx.fillText(AXES[0], ...proj([1.12, -1, -1]));
  ctx.fillText(AXES[1], ...proj([-1, 1.12, -1]));
  ctx.fillText(AXES[2], ...proj([-1, -1, 1.12]));
  for (const t of TRAJS) {
    ctx.strokeStyle = t.color; ctx.lineWidth = 1.2; ctx.globalAlpha = 0.85;
    ctx.beginPath();
    const pts = t.xyz.map(proj);
    ctx.moveTo(pts[0][0], pts[0][1]);
    for (const p of pts) ctx.lineTo(p[0], p[1]);
    ctx.stroke();
    ctx.globalAlpha = 1.0;
    dot(pts[0], "red", 3.2);                     // start marker
    dot(pts[pts.length - 1], "black", 3.2);      // end marker
  }
}
let dragging = false, px = 0, py = 0;
cv.addEventListener("mousedown", e => { dragging = true; px = e.clientX; py = e.clientY; });
addEventListener("mouseup", () => dragging = false);
addEventListener("mousemove", e => {
  if (!dragging) return;
  yaw += (e.clientX - px) * 0.008; pitch += (e.clientY - py) * 0.008;
  pitch = Math.max(-1.55, Math.min(1.55, pitch));
  px = e.clientX; py = e.clientY; draw();
});
cv.addEventListener("wheel", e => {
  e.preventDefault(); zoom *= Math.exp(-e.deltaY * 0.001); draw();
}, { passive: false });
cv.addEventListener("dblclick", () => { yaw = -0.9; pitch = 0.5; zoom = 1.0; draw(); });
addEventListener("resize", resize);
resize();
</script></body></html>
"""


def write_html_trajectories_3d(artifact: Dict[str, np.ndarray], out_path: str,
                               title: str = "", extracted=None) -> str:
    """Render the 3-D PCA trajectory view as a standalone interactive HTML
    file (the stand-in for ``plot_latent_trajectories_3D``'s
    plotly output, ``visualization.py:119-179``)."""
    trajs, mean, comps = extracted if extracted is not None else extract_pca(artifact)

    # normalize each display axis to [-1, 1] so the unit box fits any run
    xys = [(t["trajectory"] - mean) @ comps for t in trajs]
    xy_all = np.vstack(xys)
    t_max = max(int(t["time"][-1]) for t in trajs)
    lo, hi = xy_all.min(axis=0), xy_all.max(axis=0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)

    data: List[dict] = []
    for i, (t, xy) in enumerate(zip(trajs, xys)):
        xy01 = 2.0 * (xy - lo) / span - 1.0
        z01 = 2.0 * t["time"] / max(t_max, 1) - 1.0
        xyz = np.column_stack([xy01, z01]).round(4)
        data.append({"xyz": xyz.tolist(), "color": _PALETTE[i % len(_PALETTE)]})

    html = _TEMPLATE % {
        "title": _html.escape(title or os.path.basename(out_path)),
        "n_traj": len(data),
        "data": json.dumps(data, separators=(",", ":")),
    }
    with open(out_path, "w") as f:
        f.write(html)
    return out_path
