"""Loop traverser: join path pairs across short tandem-repeat components.

The port's copy of the JAX package's ``path_extend/loop_traverser.py``:
host NumPy, as there; a graph on the card is copied to the host once,
at the top of each pass (``graph/host.host_view``).

Counterpart of the reference's ``LoopTraverser``
(modules/path_extend/loop_traverser.cpp:24-210): after path extension,
small graph components made only of short edges (a tandem repeat the
extender could not resolve) often have exactly one entry path stopping
inside and one exit path starting inside. If the component has a single
entry edge and a single exit edge, no tips, and both are covered by
exactly one path each, the two paths join **with a k+100 N gap**
(loop_traverser.cpp:150 ``Gap(g.k() + BASIC_N_CNT)``) — the bounded
shortest-path search is only a feasibility check; the repeat's copy
number is unknown, so the reference never spells the loop out.

Joins are returned for the scaffolder to apply (our PathSet carries no
gaps; in the reference too, the gap surfaces in scaffolds and is broken
back out of contigs).

Defaults mirror configs/debruijn/pe_params.info loop_traversal
(min_edge_length 1000, max_component_size 10, max_path_length 1000).
"""

from __future__ import annotations

import heapq

import numpy as np

from ..graph.host import GraphView, edge_mask, host_view
from .resolver import PathSet

BASIC_N_CNT = 100  # loop_traverser.hpp:30


def _short_edge_components(alive, start_v, end_v, seq_len,
                           min_edge_length):
    """Union-find vertex components over edges shorter than the limit
    (LongEdgesExclusiveSplitter)."""
    parent: dict[int, int] = {}

    def find(x):
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for e in np.nonzero(alive)[0]:
        if seq_len[e] < min_edge_length:
            union(int(start_v[e]), int(end_v[e]))
    comps: dict[int, set[int]] = {}
    for v in list(parent):
        comps.setdefault(find(v), set()).add(v)
    return [c for c in comps.values() if len(c) > 1]


def traverse_loops(g: GraphView, ps: PathSet, min_edge_length: int = 1000,
                   max_component_size: int = 10,
                   max_path_length: int = 1000) -> list[tuple]:
    """Find loop-component joins between path pairs.

    Returns forced scaffold joins [((si, sflip), (ei, eflip), gap_bp)]
    with gap_bp = k + BASIC_N_CNT, to be applied by
    scaffolder.scaffold_paths(forced_joins=...).
    """
    g = host_view(g)
    alive = np.asarray(edge_mask(g))
    start_v = np.asarray(g.start_v)
    end_v = np.asarray(g.end_v)
    seq_len = np.asarray(g.seq_len)
    conj = np.asarray(g.conj)
    k = g.k

    out_of: dict[int, list[int]] = {}
    in_of: dict[int, list[int]] = {}
    for e in np.nonzero(alive)[0]:
        out_of.setdefault(int(start_v[e]), []).append(int(e))
        in_of.setdefault(int(end_v[e]), []).append(int(e))

    comps = _short_edge_components(alive, start_v, end_v, seq_len,
                                   min_edge_length)
    paths = ps.paths

    def covering(edge: int):
        """Paths covering ``edge`` in either orientation
        (the GraphCoverageMap lookup)."""
        ce = int(conj[edge])
        hits = []
        for i, p in enumerate(paths):
            if edge in p:
                hits.append((i, False))
            elif ce in p:
                hits.append((i, True))
        return hits

    def oriented(i: int, flip: bool) -> list[int]:
        p = paths[i]
        return [int(conj[e]) for e in reversed(p)] if flip else p

    joins: list[tuple] = []
    used: set[int] = set()
    for comp in comps:
        if len(comp) > max_component_size:
            continue
        comp_edges = [e for v in comp for e in out_of.get(v, [])
                      if int(end_v[e]) in comp]
        # ContainsLongEdges: an intra-component long edge disqualifies
        if any(seq_len[e] >= min_edge_length for e in comp_edges):
            continue
        # AnyTipsInComponent: every component vertex needs both sides
        if any(not in_of.get(v) or not out_of.get(v) for v in comp):
            continue
        entries = [e for v in comp for e in in_of.get(v, [])
                   if int(start_v[e]) not in comp]
        exits = [e for v in comp for e in out_of.get(v, [])
                 if int(end_v[e]) not in comp]
        if len(entries) != 1 or len(exits) != 1:
            continue
        entry, exit_ = entries[0], exits[0]
        if entry == exit_:
            continue

        cov_start = covering(entry)
        cov_end = covering(exit_)
        if len(cov_start) != 1 or len(cov_end) != 1:
            continue  # ambiguous situation, quitting (loop_traverser:108)
        (si, sf), (ei, ef) = cov_start[0], cov_end[0]
        if si == ei or si in used or ei in used:
            continue
        # start path already reaches the exit: loop is spanned
        if exit_ in paths[si] or int(conj[exit_]) in paths[si]:
            continue
        p_start = oriented(si, sf)
        p_end = oriented(ei, ef)
        # start path must run through the entry and END inside the
        # component; end path must START inside and leave via the exit
        ai = p_start.index(entry)
        if not all(int(end_v[e]) in comp for e in p_start[ai:]):
            continue
        bi = p_end.index(exit_)
        if not all(int(start_v[e]) in comp for e in p_end[:bi + 1]):
            continue

        # feasibility: common end, shared vertex, or a bounded shortest
        # path inside the component (CreateBoundedDijkstra)
        feasible = any(p_start[-t:] == p_end[:t]
                       for t in range(1, min(len(p_start),
                                             len(p_end)) + 1))
        src = int(end_v[p_start[-1]])
        dst = int(start_v[p_end[0]])
        if not feasible and src == dst:
            feasible = True
        if not feasible:
            best = {src: 0}
            q = [(0, src)]
            while q:
                dcur, v = heapq.heappop(q)
                if v == dst:
                    feasible = True
                    break
                if dcur > best.get(v, 1 << 30):
                    continue
                for e in out_of.get(v, []):
                    w = int(end_v[e])
                    if w not in comp and w != dst:
                        continue
                    nd = dcur + int(seq_len[e]) - k
                    if nd <= max_path_length and nd < best.get(w, 1 << 30):
                        best[w] = nd
                        heapq.heappush(q, (nd, w))
        if not feasible:
            continue
        joins.append(((si, sf), (ei, ef), k + BASIC_N_CNT))
        used.update((si, ei))
    return joins
