"""Superbubble detection and collapse (rnaSPAdes simplification).

PyTorch counterpart of the JAX package's ``simplify/superbubble.py``
(the reference's ``SuperbubbleFinder``,
assembler/src/common/modules/simplification/superbubble_finder.hpp:21):
from a branching start vertex, grow the dominated vertex set (a vertex
joins only once all its in-edges originate inside the set); if the
frontier shrinks to a single vertex with no back-edge to the start, the
set is a superbubble. The heaviest path (total k-mer multiplicity =
coverage * (len - k), the finder's weight) is kept and every other
interior edge is removed, the rnaSPAdes collapse used after the main
simplification cycle.

The condensed graph is small (thousands of edges), so detection runs on
the host in NumPy over one pull of the graph's columns; the deletions go
back as one alive mask. Parallel two-edge bubbles are already handled by
the device ``remove_bulges`` pass; this adds the multi-vertex interiors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.graph import Graph, edge_mask


def _adjacency(g: Graph):
    alive = edge_mask(g).cpu().numpy()
    start_v = g.start_v.cpu().numpy()
    end_v = g.end_v.cpu().numpy()
    out_edges: dict[int, list[int]] = {}
    in_edges: dict[int, list[int]] = {}
    for e in np.nonzero(alive)[0]:
        out_edges.setdefault(int(start_v[e]), []).append(int(e))
        in_edges.setdefault(int(end_v[e]), []).append(int(e))
    return alive, start_v, end_v, out_edges, in_edges


def find_superbubble(start: int, out_edges, in_edges, start_v, end_v,
                     weight, length, max_length: int, max_count: int):
    """Grow a superbubble from ``start``.  Returns
    (end_vertex, interior_vertices, heaviest_backtrace) or None.

    Mirrors SuperbubbleFinder's main loop: ``can_be_processed`` holds
    border vertices all of whose in-edges start inside the bubble;
    vertices are absorbed one at a time; success when the border is a
    single vertex that is processable and has no edge back to start.
    """
    inside = {start}
    border: set[int] = set()
    # per-vertex heaviest path weight / max path length from start
    best_w = {start: 0.0}
    best_len = {start: 0}
    backtrace: dict[int, int] = {}
    cnt = 0

    def processable(v):
        return all(start_v[e] in inside for e in in_edges.get(v, []))

    def absorb_frontier(v):
        for e in out_edges.get(v, []):
            border.add(end_v[e])

    absorb_frontier(start)
    if start in border:
        return None  # self-loop at start
    while True:
        if cnt > max_count:
            return None
        # success check: single border vertex, fully dominated
        if len(border) == 1:
            v = next(iter(border))
            if processable(v) and v != start:
                if any(end_v[e] == start for e in out_edges.get(v, [])):
                    return None
                # finalize v's weight for completeness
                _relax(v, in_edges, start_v, weight, length,
                       best_w, best_len, backtrace)
                if best_len[v] > max_length:
                    return None
                return v, inside - {start}, backtrace
        cand = [v for v in border if v != start and processable(v)]
        if not cand:
            return None
        v = min(cand)  # deterministic order
        border.discard(v)
        _relax(v, in_edges, start_v, weight, length,
               best_w, best_len, backtrace)
        if best_len[v] > max_length:
            return None
        inside.add(v)
        cnt += 1
        for e in out_edges.get(v, []):
            w = end_v[e]
            if w == start:
                return None  # cycle back to the start
            if w not in inside:
                border.add(w)


def _relax(v, in_edges, start_v, weight, length, best_w, best_len,
           backtrace):
    bw, bl, be = -1.0, 0, -1
    for e in in_edges.get(v, []):
        u = int(start_v[e])
        if u not in best_w:
            continue
        w = best_w[u] + weight[e]
        if w > bw or (w == bw and e < be):
            bw, be = w, e
        bl = max(bl, best_len[u] + length[e])
    best_w[v] = bw
    best_len[v] = bl
    if be >= 0:
        backtrace[v] = be


def collapse_superbubbles(g: Graph, max_length: int = 1000,
                          max_count: int = 32) -> tuple[Graph, int]:
    """Find superbubbles from every branching vertex and delete all
    interior edges off the heaviest path (+ conjugates).  Returns
    (graph, n_bubbles_collapsed).  Run recondense() afterwards."""
    alive, start_v, end_v, out_edges, in_edges = _adjacency(g)
    lens = g.seq_len.cpu().numpy()
    cov = g.cov.cpu().numpy()
    conj = g.conj.cpu().numpy()
    k = g.k
    weight = cov * np.maximum(lens - k, 1)
    elen = np.maximum(lens - k, 1)

    kill = np.zeros(g.capacity, bool)
    kept_global: set[int] = set()
    n_bubbles = 0
    for s, outs in sorted(out_edges.items()):
        if len(outs) < 2:
            continue
        if any(kill[e] for e in outs):
            continue  # already touched this round
        found = find_superbubble(s, out_edges, in_edges, start_v, end_v,
                                 weight, elen, max_length, max_count)
        if found is None:
            continue
        t, interior, backtrace = found
        # heaviest path edges: walk backtrace from t to s
        keep = set()
        v = t
        seen = 0
        while v != s and v in backtrace and seen <= max_count + 2:
            e = backtrace[v]
            keep.add(e)
            v = int(start_v[e])
            seen += 1
        if v != s:
            continue
        # bubble edges = edges fully inside {s} ∪ interior ∪ {t}
        zone = interior | {s, t}
        bubble_edges = [e for u in ({s} | interior)
                        for e in out_edges.get(u, [])
                        if end_v[e] in zone]
        doomed = [e for e in bubble_edges if e not in keep]
        if not doomed:
            continue
        if any(kill[e] for e in bubble_edges):
            continue
        # palindromic/self-overlapping regions: the conjugate of a doomed
        # edge may lie on this bubble's (or a committed) heaviest path —
        # deleting it would take the kept path down with it.  Skip.
        conj_doomed = {int(conj[e]) for e in doomed}
        if conj_doomed & (keep | kept_global):
            continue
        for e in doomed:
            kill[e] = True
            kill[conj[e]] = True
        kept_global |= keep
        n_bubbles += 1

    if not n_bubbles:
        return g, 0
    return g._replace(alive=g.alive & ~torch.from_numpy(kill).to(g.device)
                      ), n_bubbles
