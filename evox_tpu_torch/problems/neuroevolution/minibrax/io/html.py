"""Standalone-HTML trajectory renderer (the ``brax.io.html.render`` role;
counterpart of ``evox_tpu/problems/neuroevolution/minibrax/io/html.py``).

Produces a self-contained document with an inline SVG scene animated by a
small JS loop over the serialized trajectory: no external assets, so the
output opens anywhere (the property ``BraxProblem.visualize`` relies on)."""

from __future__ import annotations

import json

from .image import host


def render(sys, trajectory, height: int = 360) -> str:
    """Render a list of ``PipelineState``s for ``sys`` to an HTML string."""
    frames = [host(ps.q).tolist() for ps in trajectory]
    radii = host(sys.radius).tolist()
    dt = float(sys.dt)
    data = json.dumps({"frames": frames, "radii": radii, "dt": dt})
    return f"""<!DOCTYPE html>
<html>
<head><meta charset="utf-8"><title>minibrax trajectory</title></head>
<body style="margin:0;background:#12161d;color:#dde">
<div style="font:13px monospace;padding:4px">minibrax &mdash; {len(frames)} frames, dt={dt}</div>
<svg id="scene" width="100%" height="{height}" viewBox="-2 -0.2 4 2.4"
     preserveAspectRatio="xMidYMax meet" style="display:block">
  <rect x="-10" y="-10" width="20" height="10" fill="#2a3442"
        transform="scale(1,-1)"/>
</svg>
<script>
const data = {data};
const svg = document.getElementById("scene");
const NS = "http://www.w3.org/2000/svg";
const bodies = data.radii.map((r, i) => {{
  const c = document.createElementNS(NS, "circle");
  c.setAttribute("r", r);
  c.setAttribute("fill", ["#e8a33d", "#5aa9e6", "#9fe65a"][i % 3]);
  svg.appendChild(c);
  return c;
}});
let t = 0;
function draw() {{
  const q = data.frames[t];
  bodies.forEach((c, i) => {{
    c.setAttribute("cx", q[i][0]);
    c.setAttribute("cy", 2.2 - q[i][1]);  // flip z for screen coords
  }});
  t = (t + 1) % data.frames.length;
}}
draw();
setInterval(draw, Math.max(16, 1000 * data.dt));
</script>
</body>
</html>"""
