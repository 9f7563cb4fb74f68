"""Assembly-graph JSON export for web visualization.

PyTorch counterpart of the JAX package's ``io/graph_json.py`` (the
reference's webvis/ pipeline, pydot -> JSON graph viewer, and online_vis
picture dumps): a D3/cytoscape-style {nodes, links} document over the
conjugate-collapsed graph, built from one host copy of the graph
(``graph/host.py``).
"""

from __future__ import annotations

import json

import numpy as np

from ..graph.host import edge_mask, host_view
from ..ops import dna


def graph_to_json(g, max_label_len: int = 12) -> dict:
    """The {nodes, links, k} document of a graph or its host view."""
    hv = host_view(g)
    alive = edge_mask(hv)
    conj, starts, lens, covs = hv.conj, hv.seq_start, hv.seq_len, hv.cov
    start_v, end_v, flat = hv.start_v, hv.end_v, hv.seq_flat

    nodes = []
    vseen = {}
    for e in np.nonzero(alive)[0]:
        for v in (int(start_v[e]), int(end_v[e])):
            if v not in vseen:
                vseen[v] = len(vseen)
                nodes.append({"id": f"v{v}"})
    links = []
    for e in np.nonzero(alive)[0]:
        ce = int(conj[e])
        if ce < e and alive[ce]:
            continue
        head = dna.decode_codes(
            flat[starts[e]:starts[e] + min(int(lens[e]), max_label_len)])
        links.append({
            "id": int(e),
            "source": f"v{int(start_v[e])}",
            "target": f"v{int(end_v[e])}",
            "length": int(lens[e]),
            "coverage": round(float(covs[e]), 2),
            "label": f"{int(lens[e])}bp x{covs[e]:.0f} {head}...",
        })
    return {"nodes": nodes, "links": links, "k": hv.k}


def write_graph_json(path: str, g) -> None:
    with open(path, "w") as f:
        json.dump(graph_to_json(g), f, indent=1)
