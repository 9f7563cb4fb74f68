"""Self-contained HTML graph viewer (webvis equivalent).

PyTorch counterpart of the JAX package's ``io/webvis.py`` (the
reference's ``webvis/`` side branch, pydot -> JSON -> web viewer): ONE
standalone HTML file embedding the graph JSON (``io/graph_json.py``
schema) and a dependency-free SVG force layout, so an assembly graph
can be inspected in any browser without a server. The page is the JAX
package's, byte for byte.
"""

from __future__ import annotations

import json

from .graph_json import graph_to_json

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>assembly graph</title>
<style>
 body {{ font: 13px sans-serif; margin: 0; }}
 #info {{ position: fixed; top: 8px; left: 8px; background: #fff8;
          padding: 4px 8px; border-radius: 4px; }}
 line {{ stroke: #888; stroke-width: 1.5; }}
 line.heavy {{ stroke: #c33; }}
 circle {{ fill: #369; }}
 text {{ fill: #333; pointer-events: none; }}
</style></head><body>
<div id="info">drag nodes; edge width ~ log length, red = high coverage</div>
<svg id="g" width="100%" height="100%" viewBox="0 0 900 700"></svg>
<script>
const GRAPH = {graph_json};
const svg = document.getElementById('g');
const NS = 'http://www.w3.org/2000/svg';
const verts = new Map();
for (const l of GRAPH.links) {{
  for (const v of [l.source, l.target])
    if (!verts.has(v)) verts.set(v, {{x: 100 + Math.random()*700,
                                      y: 100 + Math.random()*500,
                                      vx: 0, vy: 0}});
}}
const covs = GRAPH.links.map(l => l.coverage);
const maxCov = Math.max(...covs, 1);
const els = [];
for (const l of GRAPH.links) {{
  const e = document.createElementNS(NS, 'line');
  e.setAttribute('stroke-width', 1 + Math.log2(1 + l.length) / 2);
  if (l.coverage > 0.5 * maxCov) e.classList.add('heavy');
  const t = document.createElementNS(NS, 'text');
  t.textContent = l.label;
  svg.appendChild(e); svg.appendChild(t);
  els.push({{l, e, t}});
}}
const circles = new Map();
for (const [v, p] of verts) {{
  const c = document.createElementNS(NS, 'circle');
  c.setAttribute('r', 5);
  svg.appendChild(c);
  circles.set(v, c);
  let drag = null;
  c.addEventListener('mousedown', ev => drag = v);
  svg.addEventListener('mousemove', ev => {{
    if (drag === v) {{
      const r = svg.getBoundingClientRect();
      p.x = (ev.clientX - r.x) / r.width * 900;
      p.y = (ev.clientY - r.y) / r.height * 700;
    }}
  }});
  svg.addEventListener('mouseup', () => drag = null);
}}
function tick() {{
  // spring layout
  for (const [v, p] of verts) {{ p.vx *= 0.85; p.vy *= 0.85; }}
  for (const a of verts.values()) for (const b of verts.values()) {{
    if (a === b) continue;
    const dx = a.x - b.x, dy = a.y - b.y;
    const d2 = Math.max(dx*dx + dy*dy, 25);
    a.vx += 800 * dx / d2; a.vy += 800 * dy / d2;
  }}
  for (const {{l}} of els) {{
    const a = verts.get(l.source), b = verts.get(l.target);
    const dx = b.x - a.x, dy = b.y - a.y;
    a.vx += dx * 0.01; a.vy += dy * 0.01;
    b.vx -= dx * 0.01; b.vy -= dy * 0.01;
  }}
  for (const p of verts.values()) {{
    p.x = Math.min(880, Math.max(20, p.x + p.vx));
    p.y = Math.min(680, Math.max(20, p.y + p.vy));
  }}
  for (const [v, c] of circles) {{
    const p = verts.get(v);
    c.setAttribute('cx', p.x); c.setAttribute('cy', p.y);
  }}
  for (const {{l, e, t}} of els) {{
    const a = verts.get(l.source), b = verts.get(l.target);
    e.setAttribute('x1', a.x); e.setAttribute('y1', a.y);
    e.setAttribute('x2', b.x); e.setAttribute('y2', b.y);
    t.setAttribute('x', (a.x + b.x) / 2); t.setAttribute('y', (a.y + b.y) / 2);
  }}
  requestAnimationFrame(tick);
}}
tick();
</script></body></html>
"""


def write_webvis_html(path: str, g) -> None:
    """Write a standalone interactive HTML view of a graph or its host
    view."""
    doc = graph_to_json(g)
    with open(path, "w") as f:
        f.write(_TEMPLATE.format(graph_json=json.dumps(doc)))
