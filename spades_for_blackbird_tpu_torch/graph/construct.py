"""Graph summary statistics.

PyTorch counterpart of ``graph_stats`` in
the JAX package's ``graph/construct.py``.
"""

from __future__ import annotations

import numpy as np

from .graph import Graph, edge_mask


def graph_stats(g: Graph) -> dict:
    """Host-side summary stats (edge count, total length, N50-ish)."""
    alive = edge_mask(g).cpu().numpy()
    lens = g.seq_len.cpu().numpy()[alive]
    covs = g.cov.cpu().numpy()[alive]
    if lens.size == 0:
        return {"edges": 0, "total_len": 0, "max_len": 0, "mean_cov": 0.0}
    slens = np.sort(lens)[::-1]
    half = slens.sum() / 2
    n50 = int(slens[np.cumsum(slens) >= half][0])
    return {
        "edges": int(alive.sum()),
        "total_len": int(lens.sum()),
        "max_len": int(lens.max()),
        "n50": n50,
        "mean_cov": float((covs * lens).sum() / lens.sum()),
    }
