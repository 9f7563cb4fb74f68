"""A NumPy view of a graph, for the passes that walk it on the host.

Gap closing, split-path filling and path extension (``path_extend/``)
walk the simplified graph edge by edge in Python, as the JAX package
does. The JAX package reads each field there with ``np.asarray``, which
cannot read a tensor on the card; the port copies the graph to the host
once, at the top of each such pass (``host_view``), and the pass reads
the copy. A view handed on to the next pass is not copied again.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .graph import Graph
from .graph import edge_mask as _device_edge_mask


@dataclass(frozen=True)
class GraphView:
    """The fields of ``graph.Graph`` as NumPy arrays (indices int64),
    ``num_edges`` as an int, and ``mask``: the alive real edges
    (``graph.edge_mask``)."""
    seq_flat: np.ndarray
    seq_start: np.ndarray
    seq_len: np.ndarray
    cov: np.ndarray
    start_v: np.ndarray
    end_v: np.ndarray
    conj: np.ndarray
    alive: np.ndarray
    mask: np.ndarray
    num_edges: int
    k: int

    @property
    def capacity(self) -> int:
        return self.seq_len.shape[0]


def host_view(g: Graph | GraphView) -> GraphView:
    """The graph's fields on the host: one copy a field, or ``g`` itself
    when it is a view already."""
    if isinstance(g, GraphView):
        return g

    def pull(t):
        return t.cpu().numpy()
    return GraphView(
        seq_flat=pull(g.seq_flat), seq_start=pull(g.seq_start),
        seq_len=pull(g.seq_len), cov=pull(g.cov), start_v=pull(g.start_v),
        end_v=pull(g.end_v), conj=pull(g.conj), alive=pull(g.alive),
        mask=pull(_device_edge_mask(g)), num_edges=int(g.num_edges), k=g.k)


def edge_mask(g: GraphView) -> np.ndarray:
    """Alive real edges of a host view (``graph.edge_mask`` on the host)."""
    return g.mask
