"""Explicit scaffold graph (the reference's "scaffolder2015").

The port's copy of the JAX package's ``path_extend/scaffold_graph.py``:
host NumPy, as there; a graph on the card is copied to the host once,
at the top of each pass (``graph/host.host_view``).

Reference: modules/path_extend/scaffolder2015/scaffold_graph.{hpp,cpp}
(ScaffoldGraph: vertices are de Bruijn EdgeIds, edges carry
(start, end, color=lib id, weight)), scaffold_graph_constructor.cpp
(SimpleScaffoldGraphConstructor::Construct iterates connection
conditions over an edge set), connection_condition2015.cpp
(PairedLibConnectionCondition / AssemblyGraphConnectionCondition),
scaffold_graph_visualizer.hpp; driven from
modules/path_extend/pipeline/launcher.cpp:57-110 (ConstructScaffoldGraph
+ PrintScaffoldGraph).

Array shape: instead of std::set / unordered_multimap storages, the
scaffold graph is a relational struct-of-arrays table (src, dst, color,
weight, gap) over plain edge-row ids, sorted by src for binary-search
adjacency.  Connection conditions are vectorized numpy filters over the
clustered paired index — no per-edge loops.  Conjugate symmetry is kept
by closure: every record (a, b) also inserts (conj(b), conj(a)), exactly
the reference's AddEdge-on-conjugates discipline (scaffold_graph.cpp).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..graph.host import GraphView, host_view


@dataclass
class ScaffoldGraph:
    """Vertices = assembly-graph edge ids; edges = putative connections.

    src/dst: (M,) int32 edge-row ids.  color: (M,) int32 library index
    (-1 for assembly-graph adjacency).  weight: (M,) float32 read-pair
    support.  gap: (M,) int32 estimated N-gap between src's end and dst's
    start (graph-adjacent connections carry -k, the sequence overlap).
    """
    vertices: np.ndarray          # (V,) sorted unique edge ids
    src: np.ndarray
    dst: np.ndarray
    color: np.ndarray
    weight: np.ndarray
    gap: np.ndarray
    order: np.ndarray = field(default=None)        # argsort by src
    order_dst: np.ndarray = field(default=None)    # argsort by dst

    def __post_init__(self):
        if self.order is None:
            self.order = np.argsort(self.src, kind="stable")
        if self.order_dst is None:
            self.order_dst = np.argsort(self.dst, kind="stable")

    @property
    def vertex_count(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def edge_count(self) -> int:
        return int(self.src.shape[0])

    def _range(self, keys_sorted, order, v):
        lo = np.searchsorted(keys_sorted, v, side="left")
        hi = np.searchsorted(keys_sorted, v, side="right")
        return order[lo:hi]

    def outgoing(self, v: int) -> np.ndarray:
        """Edge-record indices leaving vertex v (OutgoingEdges)."""
        return self._range(self.src[self.order], self.order, v)

    def incoming(self, v: int) -> np.ndarray:
        """Edge-record indices entering vertex v (IncomingEdges)."""
        return self._range(self.dst[self.order_dst], self.order_dst, v)

    def out_degree(self, v: int) -> int:
        return int(self.outgoing(v).shape[0])

    def in_degree(self, v: int) -> int:
        return int(self.incoming(v).shape[0])

    def unambiguous_joins(self) -> list[tuple[int, int, int, float]]:
        """(src, dst, gap, weight) records where src has exactly one
        distinct successor and dst exactly one distinct predecessor —
        the unique-connection criterion the reference's scaffolding
        extension chooser applies on top of the scaffold graph
        (extension_chooser2015.cpp)."""
        out = []
        for v in self.vertices:
            rec = self.outgoing(int(v))
            if rec.shape[0] == 0:
                continue
            dsts = np.unique(self.dst[rec])
            if dsts.shape[0] != 1:
                continue
            d = int(dsts[0])
            preds = np.unique(self.src[self.incoming(d)])
            if preds.shape[0] != 1:
                continue
            best = rec[np.argmax(self.weight[rec])]
            out.append((int(v), d, int(self.gap[best]),
                        float(self.weight[best])))
        return out

    def to_tsv(self) -> str:
        """Flat dump (the reference's .scg PrintScaffoldGraph output,
        launcher.cpp:85-95): one record per line."""
        lines = ["#src\tdst\tcolor\tweight\tgap"]
        for i in range(self.edge_count):
            lines.append(f"{int(self.src[i])}\t{int(self.dst[i])}\t"
                         f"{int(self.color[i])}\t{float(self.weight[i]):g}\t"
                         f"{int(self.gap[i])}")
        return "\n".join(lines) + "\n"

    def to_dot(self, g: GraphView | None = None) -> str:
        """Graphviz dump (scaffold_graph_visualizer.hpp)."""
        g = None if g is None else host_view(g)
        lens = None if g is None else np.asarray(g.seq_len)
        out = ["digraph scaffold_graph {"]
        for v in self.vertices:
            label = f"e{int(v)}" if lens is None else \
                f"e{int(v)} len={int(lens[int(v)])}"
            out.append(f'  v{int(v)} [label="{label}"];')
        for i in range(self.edge_count):
            out.append(
                f"  v{int(self.src[i])} -> v{int(self.dst[i])} "
                f'[label="w={float(self.weight[i]):g} '
                f'gap={int(self.gap[i])}" color='
                f'{"black" if self.color[i] < 0 else "blue"}];')
        out.append("}")
        return "\n".join(out) + "\n"


def paired_connection_records(g: GraphView, paired, lib_index: int,
                              min_weight: float = 5.0,
                              left_delta: int | None = None,
                              right_delta: int = 10000,
                              unique_mask: np.ndarray | None = None,
                              closure: bool = True):
    """PairedLibConnectionCondition (connection_condition2015.cpp):
    connections between (unique) edges supported by >= min_read_count
    pairs whose implied gap lies in [-left_delta, right_delta].

    ``paired``: clustered PairedIndex with *forward* oriented ids
    (mapper.normalize_mapping convention — even ids; //2 = edge row).
    Returns (src, dst, color, weight, gap) numpy arrays, conjugate-closed.
    """
    g = host_view(g)
    seq_len = np.asarray(g.seq_len)
    conj = np.asarray(g.conj)
    k = g.k
    if left_delta is None:
        left_delta = k

    n = int(paired.num)
    a = np.asarray(paired.e1)[:n] // 2
    b = np.asarray(paired.e2)[:n] // 2
    dist = np.asarray(paired.dist)[:n]
    w = np.asarray(paired.weight)[:n]

    gapv = dist - seq_len[a] + k
    keep = (w >= min_weight) & (a != b) & \
        (gapv >= -left_delta) & (gapv <= right_delta)
    if unique_mask is not None:
        keep &= unique_mask[a] & unique_mask[b]
    a, b, w, gapv = a[keep], b[keep], w[keep], gapv[keep]

    if closure:
        # conjugate closure: a->b implies conj(b)->conj(a), same gap
        src = np.concatenate([a, conj[b]])
        dst = np.concatenate([b, conj[a]])
        weight = np.concatenate([w, w]).astype(np.float32)
        gap = np.concatenate([gapv, gapv]).astype(np.int32)
    else:
        src, dst = a, b
        weight = w.astype(np.float32)
        gap = gapv.astype(np.int32)
    color = np.full(src.shape, lib_index, np.int32)
    return _dedup(src.astype(np.int32), dst.astype(np.int32),
                  color, weight, gap)


def adjacency_connection_records(g: GraphView,
                                 unique_mask: np.ndarray | None = None):
    """AssemblyGraphConnectionCondition (connection_condition2015.cpp):
    edges adjacent in the assembly graph (src's end vertex == dst's
    start vertex) connect with gap -k and infinite confidence."""
    g = host_view(g)
    start_v = np.asarray(g.start_v)
    end_v = np.asarray(g.end_v)
    alive = np.asarray(g.alive)
    ids = np.nonzero(alive)[0].astype(np.int32)
    if unique_mask is not None:
        ids = ids[unique_mask[ids]]
    # join on shared vertex: sort dst candidates by start vertex
    order = np.argsort(start_v[ids], kind="stable")
    sv_sorted = start_v[ids][order]
    lo = np.searchsorted(sv_sorted, end_v[ids], side="left")
    hi = np.searchsorted(sv_sorted, end_v[ids], side="right")
    counts = hi - lo
    src = np.repeat(ids, counts)
    take = np.concatenate(
        [order[l:h] for l, h in zip(lo, hi)]) if src.size else \
        np.zeros((0,), np.int64)
    dst = ids[take]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    color = np.full(src.shape, -1, np.int32)
    weight = np.full(src.shape, np.float32(1e9))
    gap = np.full(src.shape, -g.k, np.int32)
    return src.astype(np.int32), dst.astype(np.int32), color, weight, gap


def _dedup(src, dst, color, weight, gap):
    """Collapse duplicate (src, dst, color) records, max weight wins
    (the constructor's duplicate-edge guard, scaffold_graph.cpp)."""
    if src.size == 0:
        return src, dst, color, weight, gap
    order = np.lexsort((gap, -weight, color, dst, src))
    src, dst, color = src[order], dst[order], color[order]
    weight, gap = weight[order], gap[order]
    first = np.ones(src.shape, bool)
    first[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1]) | \
        (color[1:] != color[:-1])
    return (src[first], dst[first], color[first], weight[first],
            gap[first])


def build_scaffold_graph(g: GraphView, record_sets) -> ScaffoldGraph:
    """ConstructFromConditions (scaffold_graph_constructor.cpp): merge
    connection-condition record sets into one graph."""
    g = host_view(g)
    if record_sets:
        src = np.concatenate([r[0] for r in record_sets])
        dst = np.concatenate([r[1] for r in record_sets])
        color = np.concatenate([r[2] for r in record_sets])
        weight = np.concatenate([r[3] for r in record_sets])
        gap = np.concatenate([r[4] for r in record_sets])
    else:
        src = dst = color = gap = np.zeros((0,), np.int32)
        weight = np.zeros((0,), np.float32)
    vertices = np.unique(np.concatenate([src, dst])) if src.size else \
        np.zeros((0,), np.int32)
    return ScaffoldGraph(vertices=vertices.astype(np.int32), src=src,
                         dst=dst, color=color, weight=weight, gap=gap)


def scaffold_graph_from_paired(g: GraphView, paired_per_lib,
                               min_weight: float = 5.0,
                               max_gap: int = 10000,
                               unique_mask: np.ndarray | None = None,
                               with_adjacency: bool = True
                               ) -> ScaffoldGraph:
    """ConstructScaffoldGraph (launcher.cpp:57-83): one paired condition
    per library + the assembly-graph adjacency condition."""
    g = host_view(g)
    sets = []
    for li, paired in enumerate(paired_per_lib):
        sets.append(paired_connection_records(
            g, paired, li, min_weight=min_weight, right_delta=max_gap,
            unique_mask=unique_mask))
    if with_adjacency:
        sets.append(adjacency_connection_records(g, unique_mask))
    return build_scaffold_graph(g, sets)
