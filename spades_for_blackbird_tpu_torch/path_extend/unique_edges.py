"""Scaffolding unique-edge storage and multiplicity estimation.

The port's copy of the JAX package's ``path_extend/unique_edges.py``:
host NumPy, as there; a graph on the card is copied to the host once,
at the top of each pass (``graph/host.host_view``).

Counterpart of the reference's ScaffoldingUniqueEdgeAnalyzer/-Storage
(assembly_graph/graph_support/scaff_supplementary.{hpp,cpp}): an edge is
"unique" (single-copy, usable as a scaffolding anchor) iff it is at
least ``length_cutoff`` long AND its coverage lies within
``median * (1 +- variation)`` of the length-weighted median coverage of
long edges (scaff_supplementary.cpp:55-62).  Multiplicity of shorter
edges is coverage / median, the copy count a collapsed repeat represents.
"""

from __future__ import annotations

import numpy as np

from ..graph.host import GraphView, edge_mask, host_view


def median_long_coverage(g: GraphView, length_cutoff: int) -> float:
    """Length-weighted median coverage of edges >= length_cutoff
    (ScaffoldingUniqueEdgeAnalyzer::SetCoverageBasedCutoff,
    scaff_supplementary.cpp:30-45)."""
    g = host_view(g)
    alive = np.asarray(edge_mask(g))
    lens = (np.asarray(g.seq_len) - g.k)[alive]
    covs = np.asarray(g.cov)[alive]
    sel = lens >= length_cutoff
    if not sel.any():
        sel = lens > 0
        if not sel.any():
            return 0.0
    lens, covs = lens[sel], covs[sel]
    order = np.argsort(covs)
    csum = np.cumsum(lens[order])
    i = int(np.searchsorted(csum, csum[-1] / 2.0))
    return float(covs[order[min(i, len(order) - 1)]])


def unique_edge_mask(g: GraphView, length_cutoff: int,
                     variation: float = 0.5) -> np.ndarray:
    """Per-edge-row uniqueness (scaff_supplementary.cpp:55-62)."""
    g = host_view(g)
    median = median_long_coverage(g, length_cutoff)
    alive = np.asarray(edge_mask(g))
    lens = np.asarray(g.seq_len) - g.k
    covs = np.asarray(g.cov)
    if median <= 0:
        return alive & (lens >= length_cutoff)
    return alive & (lens >= length_cutoff) & \
        (covs > median * (1.0 - variation)) & \
        (covs < median * (1.0 + variation))


def edge_multiplicity(g: GraphView, length_cutoff: int) -> np.ndarray:
    """Estimated copy number per edge row: round(cov / median of long
    unique coverage), min 1 for alive edges."""
    g = host_view(g)
    median = median_long_coverage(g, length_cutoff)
    covs = np.asarray(g.cov)
    alive = np.asarray(edge_mask(g))
    if median <= 0:
        return alive.astype(np.int32)
    m = np.round(covs / median).astype(np.int32)
    return np.where(alive, np.maximum(m, 1), 0)
