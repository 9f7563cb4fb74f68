"""Advanced simplification, in part: path bulges and complex tips.

PyTorch counterpart of the parts of
``spades_for_blackbird_tpu/simplify/advanced.py`` that the isolate
defaults of ``SimplifyConfig`` run:

- path-alternative bulge removal (modules/simplification/
  bulge_remover.hpp:200 ``AlternativesAnalyzer`` +
  ``MostCoveredSimpleAlternativePathChooser:64``)
- complex tip clipper (modules/simplification/complex_tip_clipper.hpp:19
  + dominated_set_finder.hpp:7)

These cleaners walk small bounded neighbourhoods of the compacted graph
on the host over a mutable NumPy view (``HostGraph``), as the JAX package
does; only the device boundary differs: the alive rows are pulled with
``.cpu()`` and the edited columns pushed back as tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.graph import Graph, edge_mask


class Range:
    __slots__ = ("start", "end")

    def __init__(self, start: int, end: int):
        self.start, self.end = start, end


class HostGraph:
    """Mutable host-side view of the edge table with adjacency upkeep.

    Plays the role the reference's ObservableGraph + action handlers play
    during sequential simplification (core/observable_graph.hpp:21):
    deletions keep the adjacency coherent so later candidates see the
    current graph. The JAX package's HostGraph also disconnects edges
    and mints vertices for passes the port does not run yet; those
    methods come with those passes.
    """

    def __init__(self, g: Graph, v_space: int):
        self.k = g.k
        self.capacity = g.capacity
        # pull only the alive rows
        E = g.capacity
        ids_dev = torch.nonzero(edge_mask(g)).flatten()
        ids = ids_dev.cpu().numpy()

        def pull(col, dtype):
            out = np.zeros(E, dtype)
            out[ids] = col[ids_dev].cpu().numpy()
            return out

        self.alive = np.zeros(E, bool)
        self.alive[ids] = True
        self.start_v = pull(g.start_v, np.int64)
        self.end_v = pull(g.end_v, np.int64)
        self.conj = pull(g.conj, np.int64)
        self.cov = pull(g.cov, np.float64)
        self.flank = None if g.flank is None else pull(g.flank, np.float64)
        self.seq_start = pull(g.seq_start, np.int64)
        self.seq_len = pull(g.seq_len, np.int64)
        self.seq_flat = g.seq_flat  # immutable here
        self._flat_host = None      # memoized host copy
        self._g = g
        self.out: dict[int, list[int]] = {}
        self.inc: dict[int, list[int]] = {}
        for e in np.nonzero(self.alive)[0]:
            e = int(e)
            self.out.setdefault(int(self.start_v[e]), []).append(e)
            self.inc.setdefault(int(self.end_v[e]), []).append(e)
        self.v_space = v_space

    # --- queries ------------------------------------------------------
    def len_k(self, e: int) -> int:
        """Edge length in k-mers (the reference's g.length())."""
        return int(self.seq_len[e]) - self.k

    def flat_host(self) -> np.ndarray:
        """Host copy of the code buffer (memoized)."""
        if self._flat_host is None:
            self._flat_host = self.seq_flat.cpu().numpy()
        return self._flat_host

    def out_edges(self, v: int) -> list[int]:
        return [e for e in self.out.get(v, []) if self.alive[e]]

    def in_edges(self, v: int) -> list[int]:
        return [e for e in self.inc.get(v, []) if self.alive[e]]

    def incident(self, v: int) -> list[int]:
        return self.out_edges(v) + [e for e in self.in_edges(v)
                                    if int(self.start_v[e]) != v]

    # --- mutations ----------------------------------------------------
    def kill(self, e: int) -> None:
        for x in (e, int(self.conj[e])):
            self.alive[x] = False

    def add_cov(self, e: int, dc: float) -> None:
        for x in {e, int(self.conj[e])}:
            self.cov[x] += dc
            if self.flank is not None:
                self.flank[x] += dc

    # --- output -------------------------------------------------------
    def to_graph(self) -> tuple[Graph, int]:
        g = self._g
        dev = g.device

        def push(col, dtype):
            return torch.from_numpy(col.astype(dtype)).to(dev)

        real = torch.arange(self.capacity, device=dev) < g.num_edges
        out = g._replace(
            alive=push(self.alive, bool) & real,
            start_v=push(self.start_v, np.int64),
            end_v=push(self.end_v, np.int64),
            cov=push(self.cov, np.float32),
            seq_start=push(self.seq_start, np.int64),
            seq_len=push(self.seq_len, np.int64),
            flank=(None if self.flank is None
                   else push(self.flank, np.float32)),
        )
        return out, self.v_space


# ---------------------------------------------------------------------
# Path-alternative bulge remover
# ---------------------------------------------------------------------

def _avg_cov(hv: HostGraph, path: list[int]) -> float:
    num = sum(hv.cov[p] * hv.len_k(p) for p in path)
    den = sum(hv.len_k(p) for p in path)
    return num / max(den, 1)


def _simple_path_condition(hv: HostGraph, e: int, path: list[int]) -> bool:
    """SimplePathCondition (bulge_remover.hpp:26): no self-conjugate
    candidate, path avoids e/conj(e), no repeated or conjugate-paired
    path edges, no self-conjugate path edges."""
    if int(hv.conj[e]) == e:
        return False
    seen = set()
    for p in path:
        pc = int(hv.conj[p])
        if p == e or pc == e or p == pc or p in seen or pc in seen:
            return False
        seen.add(p)
    return True


def _most_covered_alt_path(hv: HostGraph, e: int, min_len: int,
                           max_len: int, max_edge_cnt: int,
                           vertex_limit: int) -> list[int] | None:
    """Bounded exhaustive path search start(e)->end(e) keeping the most
    covered simple alternative (PathProcessor + MostCoveredSimpleAlternative
    PathChooser, bulge_remover.hpp:64; paths measured in k-mers)."""
    start, end = int(hv.start_v[e]), int(hv.end_v[e])
    best_path: list[int] | None = None
    best_cov = -1.0
    visited = 0
    stack: list[tuple[int, int, tuple[int, ...]]] = [(start, 0, ())]
    while stack:
        v, length, path = stack.pop()
        visited += 1
        if visited > vertex_limit:
            break
        if v == end and path and min_len <= length <= max_len:
            lp = list(path)
            if _simple_path_condition(hv, e, lp):
                c = _avg_cov(hv, lp)
                if c > best_cov:
                    best_cov, best_path = c, lp
        for nxt in hv.out_edges(v):
            if nxt == e or len(path) >= max_edge_cnt:
                continue
            nl = length + hv.len_k(nxt)
            if nl > max_len or nxt in path:
                continue
            stack.append((int(hv.end_v[nxt]), nl, path + (nxt,)))
    return best_path


def _identity(hv: HostGraph, e: int, path: list[int],
              min_identity: float) -> bool:
    """IdentityCondition (bulge_remover.hpp:227): 1 - editdist/len >=
    min_identity between the bulge and the alternative path sequence."""
    if min_identity <= 0.0:
        return True
    flat = hv.flat_host()
    s1 = flat[hv.seq_start[e]:hv.seq_start[e] + hv.seq_len[e]]
    parts = []
    for i, p in enumerate(path):
        seq = flat[hv.seq_start[p]:hv.seq_start[p] + hv.seq_len[p]]
        parts.append(seq if i == 0 else seq[hv.k:])
    s2 = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    n, m = len(s1), len(s2)
    prev = np.arange(m + 1)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, np.int64)
        cur[0] = i
        sub = prev[:-1] + (s2 != s1[i - 1])
        np.minimum(sub, prev[1:] + 1, out=cur[1:])
        for j in range(1, m + 1):  # insertion relaxation
            if cur[j] > cur[j - 1] + 1:
                cur[j] = cur[j - 1] + 1
        prev = cur
    ident = max(0.0, 1.0 - prev[m] / max(n, m, 1))
    return ident >= min_identity


def remove_path_bulges(g: Graph, v_space: int, *,
                       max_length: int,
                       max_coverage: float = 1000.0,
                       max_relative_coverage: float = 1.1,
                       max_delta: int = 3,
                       max_relative_delta: float = 0.1,
                       max_edge_cnt: int = 32,
                       vertex_limit: int = 3000,
                       min_identity: float = 0.0
                       ) -> tuple[Graph, int, int]:
    """Glue bulge edges onto their most-covered alternative *path*
    (AlternativesAnalyzer, bulge_remover.hpp:200-290; gluing projects the
    bulge's coverage mass onto the path, BulgeGluer:108).

    Candidates are processed lightest-coverage first (the reference's
    CoverageComparator ordering). Returns (graph, v_space, n_glued).
    """
    hv = HostGraph(g, v_space)
    ids = np.nonzero(hv.alive)[0]
    order = ids[np.argsort(hv.cov[ids], kind="stable")]
    n = 0
    for e in order:
        e = int(e)
        if not hv.alive[e]:
            continue
        lk = hv.len_k(e)
        if lk > max_length or hv.cov[e] > max_coverage:
            continue
        delta = max(int(np.floor(max_relative_delta * lk)), max_delta)
        path = _most_covered_alt_path(
            hv, e, max(lk - delta, 0), lk + delta, max_edge_cnt,
            vertex_limit)
        if path is None:
            continue
        # BulgeCondition (bulge_remover.hpp:221)
        if _avg_cov(hv, path) * max_relative_coverage < hv.cov[e]:
            continue
        if not _identity(hv, e, path, min_identity):
            continue
        # project coverage mass of e onto the path edges
        path_len = sum(hv.len_k(p) for p in path)
        dc = hv.cov[e] * lk / max(path_len, 1)
        hv.kill(e)
        for p in path:
            hv.add_cov(p, dc)
        n += 1
    gg, vs = hv.to_graph()
    return gg, vs, n


# ---------------------------------------------------------------------
# Complex tip clipper
# ---------------------------------------------------------------------

def _fill_dominated(hv: HostGraph, start: int, max_length: int,
                    max_count: int) -> dict[int, Range] | None:
    """DominatedSetFinder::FillDominated (dominated_set_finder.hpp:88)."""
    from collections import deque
    dominated: dict[int, Range] = {start: Range(0, 0)}

    def processable(v: int) -> bool:
        return all(int(hv.start_v[e]) in dominated for e in hv.in_edges(v))

    def push_neighbours(v: int, q) -> None:
        for e in hv.out_edges(v):
            w = int(hv.end_v[e])
            if processable(w):
                q.append(w)

    q = deque()
    push_neighbours(start, q)
    cnt = 1
    while q:
        cnt += 1
        if cnt > max_count:
            return None
        v = q.popleft()
        if v in dominated:
            continue
        lo, hi = 1 << 60, 0
        for e in hv.in_edges(v):
            r = dominated.get(int(hv.start_v[e]))
            if r is None:
                continue
            lo = min(lo, r.start + hv.len_k(e))
            hi = max(hi, r.end + hv.len_k(e))
        if lo > max_length:
            return None
        if any(int(hv.end_v[e]) == start for e in hv.out_edges(v)):
            continue
        dominated[v] = Range(lo, hi)
        push_neighbours(v, q)
    return dominated


def clip_complex_tips(g: Graph, v_space: int, *,
                      max_edge_len: int = 100,
                      max_path_len: int,
                      relative_coverage: float = -1.0,
                      max_count: int = 64
                      ) -> tuple[Graph, int, int]:
    """ComplexTipClipper (complex_tip_clipper.hpp:19): from every dead
    start, grow the dominated vertex set; the component (internal edges +
    exit out-edges) is wiped when every edge is short, it is not a plain
    tip, and its coverage is relatively low. Returns
    (graph, v_space, n_clipped).
    """
    hv = HostGraph(g, v_space)
    n = 0
    roots = sorted({int(v) for v in hv.start_v[hv.alive]})
    for v in roots:
        if hv.in_edges(v) or not hv.out_edges(v):
            continue
        dom = _fill_dominated(hv, v, max_path_len, max_count)
        if dom is None:
            continue
        comp_edges: set[int] = set()
        for u in dom:
            for e in hv.out_edges(u):
                if int(hv.end_v[e]) in dom:
                    comp_edges.add(e)
        ok = True
        for u in dom:
            for e in hv.out_edges(u):
                if int(hv.end_v[e]) not in dom:  # exit edge
                    if dom[u].end + hv.len_k(e) > max_path_len:
                        ok = False
                        break
                    comp_edges.add(e)
            if not ok:
                break
        if not ok or not comp_edges:
            continue
        # ComponentCheck (complex_tip_clipper.hpp:52)
        verts = {v} | {int(hv.end_v[e]) for e in comp_edges} | \
            {int(hv.start_v[e]) for e in comp_edges}
        if len(verts) == 2:
            continue  # plain tip — the simple clipper owns it
        if any(hv.len_k(e) > max_edge_len for e in comp_edges):
            continue
        if relative_coverage >= 0.0:
            tip_cov = min(hv.cov[e] for e in comp_edges)
            outward = 0.0
            for u in verts:
                for e in hv.incident(u):
                    if e not in comp_edges:
                        outward = max(outward, hv.cov[e])
            if outward > 0 and tip_cov / outward >= relative_coverage:
                continue
        for e in list(comp_edges):
            if hv.alive[e]:
                hv.kill(e)
        n += 1
    gg, vs = hv.to_graph()
    return gg, vs, n

