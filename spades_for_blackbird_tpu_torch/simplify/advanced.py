"""Advanced simplification: path bulges, relative-coverage components,
complex tips, topology-based and hidden erroneous connections.

PyTorch counterpart of the JAX package's ``simplify/advanced.py``
(the reference's sequential "hard" cleaners):

- path-alternative bulge removal (modules/simplification/
  bulge_remover.hpp:200 ``AlternativesAnalyzer`` +
  ``MostCoveredSimpleAlternativePathChooser:64``)
- relative-coverage component remover
  (modules/simplification/relative_coverage_remover.hpp:220-745)
- complex tip clipper (modules/simplification/complex_tip_clipper.hpp:19
  + dominated_set_finder.hpp:7)
- the MDA topology block: topology-based, topology-and-reliability and
  multiplicity-counting EC removal and the thorn remover
  (single_cell_simplification.hpp, topological_edge_conditions.hpp)
- hidden-EC removers (erroneous_connection_remover.hpp:414
  ``MetaHiddenECRemover``, :499 ``HiddenECRemover``)

These cleaners walk small bounded neighbourhoods of the compacted graph
on the host over a mutable NumPy view (``HostGraph``), as the JAX package
does; only the device boundary differs: the alive rows are pulled with
``.cpu()`` and the edited columns pushed back as tensors. Not ported yet:
the relative-coverage edge disconnector (meta's red block), the
mismatch-tip mask and the low-complexity clippers (rna) and the max-flow
EC remover.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from ..graph.graph import Graph, edge_mask
from .recondense import recondense


class Range:
    __slots__ = ("start", "end")

    def __init__(self, start: int, end: int):
        self.start, self.end = start, end


class HostGraph:
    """Mutable host-side view of the edge table with adjacency upkeep.

    Plays the role the reference's ObservableGraph + action handlers play
    during sequential simplification (core/observable_graph.hpp:21):
    deletions and disconnections keep the adjacency coherent so later
    candidates see the current graph. A disconnection mints a vertex and
    may double ``v_space``, which ``to_graph`` hands back.
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
        used = [0]
        if ids.size:
            used.append(int(self.start_v[ids].max()))
            used.append(int(self.end_v[ids].max()))
        self.next_vbase = max(used) // 2 + 1
        self.v_space = v_space
        self.n_changed = 0

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

    def is_dead_end(self, v: int) -> bool:
        return not self.out_edges(v)

    def is_dead_start(self, v: int) -> bool:
        return not self.in_edges(v)

    def local_cov(self, e: int, v: int) -> float:
        """FlankingCoverage::LocalCoverage (detail_coverage.hpp:109):
        flank at whichever end of ``e`` touches ``v``; falls back to the
        whole-edge average when flanks are unavailable."""
        if self.flank is None:
            return float(self.cov[e])
        if int(self.start_v[e]) == v:
            return float(self.flank[e])
        return float(self.flank[self.conj[e]])

    # --- mutations ----------------------------------------------------
    def kill(self, e: int) -> None:
        for x in (e, int(self.conj[e])):
            self.alive[x] = False
        self.n_changed += 1

    def _new_vertex(self) -> int:
        v = 2 * self.next_vbase
        self.next_vbase += 1
        if 2 * self.next_vbase > self.v_space:
            self.v_space *= 2
        return v

    def add_cov(self, e: int, dc: float) -> None:
        for x in {e, int(self.conj[e])}:
            self.cov[x] += dc
            if self.flank is not None:
                self.flank[x] += dc

    def disconnect_start(self, e: int, trim: int = 1) -> None:
        """EdgeDisconnector (edge_removal.hpp:134): remove the first
        ``trim`` (k+1)-mers of ``e``, detaching it from its start vertex
        (the conjugate edge loses its last ``trim``)."""
        e = int(e)
        ec = int(self.conj[e])
        lk = self.len_k(e)
        if lk <= trim or (ec == e and lk <= 2 * trim):
            self.kill(e)
            return
        old_start = int(self.start_v[e])
        v_new = self._new_vertex()
        self.out[old_start].remove(e)
        self.out.setdefault(v_new, []).append(e)
        self.start_v[e] = v_new
        self.seq_start[e] += trim
        self.seq_len[e] -= trim
        if ec == e:
            # self-conjugate: the same physical edge loses both flanks
            self.seq_len[e] -= trim
            self.inc[old_start ^ 1].remove(e)
            self.inc.setdefault(v_new ^ 1, []).append(e)
            self.end_v[e] = v_new ^ 1
        else:
            old_end = int(self.end_v[ec])
            self.inc[old_end].remove(ec)
            self.inc.setdefault(v_new ^ 1, []).append(ec)
            self.end_v[ec] = v_new ^ 1
            self.seq_len[ec] -= trim
        self.n_changed += 1

    def disconnect_all_out(self, v: int) -> None:
        """MetaHiddenECRemover::DisconnectEdges (erroneous_connection_
        remover.hpp:424): disconnect every out-edge of ``v`` until it is
        a dead end."""
        guard = 0
        while not self.is_dead_end(v) and guard < 64:
            self.disconnect_start(self.out_edges(v)[0], trim=self.k + 1)
            guard += 1

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
                       min_identity: float = 0.0,
                       protected: np.ndarray | None = None
                       ) -> tuple[Graph, int, int]:
    """Glue bulge edges onto their most-covered alternative *path*
    (AlternativesAnalyzer, bulge_remover.hpp:200-290; gluing projects the
    bulge's coverage mass onto the path, BulgeGluer:108).

    Candidates are processed lightest-coverage first (the reference's
    CoverageComparator ordering); ``protected`` edges ((E,) bool on the
    host: the fork's restricted edges) are never glued away. Returns
    (graph, v_space, n_glued).
    """
    hv = HostGraph(g, v_space)
    ids = np.nonzero(hv.alive)[0]
    order = ids[np.argsort(hv.cov[ids], kind="stable")]
    n = 0
    for e in order:
        e = int(e)
        if not hv.alive[e]:
            continue
        if protected is not None and protected[e]:
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



# ---------------------------------------------------------------------
# Relative-coverage component remover (relative_coverage_remover.hpp)
# ---------------------------------------------------------------------

def _max_local(hv: HostGraph, edges, v: int) -> float:
    return max((hv.local_cov(e, v) for e in edges), default=0.0)


def _any_highly_covered_both_sides(hv: HostGraph, v: int, base: float,
                                   gap: float) -> bool:
    """RelativeCoverageHelper::AnyHighlyCoveredOnBothSides
    (relative_coverage_remover.hpp:258)."""
    return (_max_local(hv, hv.in_edges(v), v) > base * gap and
            _max_local(hv, hv.out_edges(v), v) > base * gap)


class _Component:
    """relative_coverage::Component (relative_coverage_remover.hpp:27)."""

    def __init__(self, hv: HostGraph, e: int):
        self.hv = hv
        self.edges: set[int] = {e}
        self.inner: set[int] = set()
        self.border: set[int] = {int(hv.start_v[e]), int(hv.end_v[e])}
        self.terminating: set[int] = set()
        self.cumm_length = hv.len_k(e)
        self.contains_deadends = False

    def make_inner(self, v: int) -> None:
        hv = self.hv
        if hv.is_dead_end(v) or hv.is_dead_start(v):
            self.contains_deadends = True
        self.inner.add(v)
        for e in hv.incident(v):
            if e not in self.edges:
                self.edges.add(e)
                self.cumm_length += hv.len_k(e)
                other = (int(hv.end_v[e]) if int(hv.start_v[e]) == v
                         else int(hv.start_v[e]))
                if other not in self.inner:
                    self.border.add(other)
        self.border.discard(v)


def _longest_connecting_path(hv: HostGraph, comp: _Component) -> int | None:
    """LongestPathFinder (relative_coverage_remover.hpp:323): longest
    terminating-to-terminating path through the component; None when the
    component contains a cycle or no such path."""
    memo: dict[int, int] = {}
    NEG = -(1 << 60)

    def compute(v: int, stack: set[int]) -> int | None:
        if v in memo:
            return memo[v]
        if v in stack:
            return None  # cycle
        stack.add(v)
        d = NEG
        for e in hv.in_edges(v):
            if e in comp.edges:
                sub = compute(int(hv.start_v[e]), stack)
                if sub is None:
                    return None
                if sub > NEG:
                    d = max(d, sub + hv.len_k(e))
        if v in comp.terminating:
            d = max(d, 0)
        stack.discard(v)
        memo[v] = d
        return d

    best = 0
    for v in comp.terminating:
        d = compute(v, set())
        if d is None:
            return None
        best = max(best, d)
    return best if best > 0 else None


def remove_rcc_components(g: Graph, v_space: int, *,
                          coverage_gap: float,
                          length_bound: int,
                          tip_allowing_length_bound: int,
                          longest_connecting_path_bound: int,
                          max_coverage: float = float("inf"),
                          vertex_count_limit: int = 10
                          ) -> tuple[Graph, int, int]:
    """Remove relatively-low-covered components hemmed in by highly
    covered flanks on every side (RelativeCoverageComponentRemover,
    relative_coverage_remover.hpp:692; component growth = InnerComponent
    Searcher:476, acceptance = ComponentChecker:397).

    The reference re-queues the neighbourhood after every removal and
    compresses the locality of every deletion on the spot; that is
    expressed here, as in the JAX package, as whole passes in coverage
    order to a fixpoint with a recondense between passes. Length bounds
    are in k-mers; local coverage uses edge flanks. Returns (graph,
    v_space, n_removed).
    """
    n_removed = 0
    progressed = True
    while progressed:
        hv = HostGraph(g, v_space)
        ids = np.nonzero(hv.alive)[0]
        order = ids[np.argsort(hv.cov[ids], kind="stable")]
        n_before = n_removed
        for e in order:
            e = int(e)
            if not hv.alive[e]:
                continue
            v = int(hv.start_v[e])
            # outer-cycle guard (RelativeCovComponentFinder::operator():645)
            if not hv.in_edges(v) or len(hv.out_edges(v)) < 2:
                continue
            base = hv.local_cov(e, v)
            if not _any_highly_covered_both_sides(hv, v, base, coverage_gap):
                continue
            comp = _Component(hv, e)
            failed = False
            while comp.border:
                if len(comp.inner) > vertex_count_limit:
                    failed = True
                    break
                bv = min(comp.border)
                # IsTerminateVertex (relative_coverage_remover.hpp:530)
                base_cov = _max_local(
                    hv, [x for x in hv.incident(bv) if x in comp.edges], bv)
                ins = [x for x in hv.in_edges(bv) if x not in comp.edges]
                outs = [x for x in hv.out_edges(bv) if x not in comp.edges]
                terminate = (
                    _max_local(hv, outs, bv) > base_cov * coverage_gap and
                    _max_local(hv, ins, bv) > base_cov * coverage_gap)
                if terminate:
                    comp.terminating.add(bv)
                    comp.border.discard(bv)
                else:
                    comp.make_inner(bv)
                    if bv in comp.terminating:
                        failed = True
                        break
            if failed:
                continue
            # FullCheck (ComponentChecker:442)
            lcp = _longest_connecting_path(hv, comp)
            if lcp is not None and lcp >= longest_connecting_path_bound:
                continue
            if not comp.contains_deadends and comp.cumm_length > length_bound:
                continue
            if comp.cumm_length > tip_allowing_length_bound:
                continue
            if len(comp.inner) > vertex_count_limit:
                continue
            if any(hv.cov[x] > max_coverage for x in comp.edges):
                continue
            for x in list(comp.edges):
                if hv.alive[x]:
                    hv.kill(x)
            n_removed += 1
        progressed = n_removed > n_before
        g, v_space = hv.to_graph()
        if progressed:
            g = recondense(g, v_space)
    return g, v_space, n_removed


# ---------------------------------------------------------------------
# Topology-based EC removers (the MDA topology block)
# ---------------------------------------------------------------------

def _unique_path_len_lower_bound(hv: HostGraph, e: int, bound: int) -> int:
    """UniquePathLengthLowerBound: walk back through unambiguous
    extensions accumulating length (basic_edge_conditions.hpp)."""
    total = hv.len_k(e)
    cur = e
    guard = 0
    while total < bound and guard < 1000:
        v = int(hv.start_v[cur])
        ins = hv.in_edges(v)
        if len(ins) != 1 or len(hv.out_edges(v)) != 1:
            break
        cur = ins[0]
        total += hv.len_k(cur)
        guard += 1
    return total


def _bidir_unique_path_len(hv: HostGraph, e: int, bound: int) -> int:
    """max(forward, backward) cumulative unique-path length through e
    (PathLengthLowerBound + UniquePathFinder,
    topological_edge_conditions.hpp:9-54)."""
    back = _unique_path_len_lower_bound(hv, e, bound)
    total = hv.len_k(e)
    cur = e
    guard = 0
    while total < bound and guard < 1000:
        v = int(hv.end_v[cur])
        outs = hv.out_edges(v)
        if len(outs) != 1 or len(hv.in_edges(v)) != 1:
            break
        cur = outs[0]
        total += hv.len_k(cur)
        guard += 1
    return max(back, total)


def _plausible_path_len(hv: HostGraph, e: int, limit: int,
                        forward: bool) -> int:
    """Longest path length starting with e within ``limit``
    (PlausiblePathFinder, bounded DFS)."""
    best = 0
    stack = [(e, hv.len_k(e))]
    seen = 0
    while stack and seen < 512:
        seen += 1
        cur, ln = stack.pop()
        best = max(best, ln)
        if ln >= limit:
            return best
        v = int(hv.end_v[cur]) if forward else int(hv.start_v[cur])
        nxt = hv.out_edges(v) if forward else hv.in_edges(v)
        for o in nxt:
            stack.append((o, ln + hv.len_k(o)))
    return best


def _by_length(hv: HostGraph) -> np.ndarray:
    """Alive edge ids, shortest first (stable)."""
    ids = np.nonzero(hv.alive)[0]
    return ids[np.argsort(hv.seq_len[ids], kind="stable")]


def _has_alternatives(hv: HostGraph, e: int) -> bool:
    """AddAlternativesPresenceCondition: start_v has another out-edge and
    end_v another in-edge."""
    return (len(hv.out_edges(int(hv.start_v[e]))) > 1
            and len(hv.in_edges(int(hv.end_v[e]))) > 1)


def _unique_flank(hv: HostGraph, e: int, uniqueness_length: int,
                  forward: bool) -> bool:
    """The junction ``e`` hangs off (its start vertex looking forward,
    its end vertex looking backward) has a single flank edge, lying on a
    unique path of at least ``uniqueness_length``."""
    flank = (hv.in_edges(int(hv.start_v[e])) if forward
             else hv.out_edges(int(hv.end_v[e])))
    return len(flank) == 1 and _bidir_unique_path_len(
        hv, flank[0], uniqueness_length) >= uniqueness_length


def _siblings(hv: HostGraph, e: int, forward: bool) -> list[int]:
    """The other edges of ``e``'s junction: out-edges of its start
    vertex (forward) or in-edges of its end vertex."""
    edges = (hv.out_edges(int(hv.start_v[e])) if forward
             else hv.in_edges(int(hv.end_v[e])))
    return [o for o in edges if o != e]


def remove_topology_ec(g: Graph, v_space: int, *,
                       max_ec_length: int,
                       uniqueness_length: int = 1500,
                       plausibility_length: int = 200
                       ) -> tuple[Graph, int, int]:
    """Topology-based erroneous-connection removal
    (TopologyRemoveErroneousEdges, single_cell_simplification.hpp:43-57
    + DefaultUniquenessPlausabilityCondition,
    topological_edge_conditions.hpp:67-162): a short edge is removed
    when, looking from either endpoint, the junction it hangs off has a
    single UNIQUE flank edge (unique path >= uniqueness_length) and some
    OTHER edge with a PLAUSIBLE continuation (path >=
    plausibility_length). Candidates are processed in length order with
    the alternatives-presence guard; iterates to a fixpoint with
    recondense between passes. Lengths in k-mers. Returns (graph,
    v_space, n_removed)."""
    n_removed = 0
    progressed = True
    while progressed:
        hv = HostGraph(g, v_space)
        n_before = n_removed
        for e in _by_length(hv):
            e = int(e)
            if not hv.alive[e] or hv.len_k(e) > max_ec_length \
                    or not _has_alternatives(hv, e):
                continue
            if any(_unique_flank(hv, e, uniqueness_length, fwd) and any(
                    _plausible_path_len(hv, o, 2 * plausibility_length, fwd)
                    >= plausibility_length for o in _siblings(hv, e, fwd))
                   for fwd in (True, False)):
                hv.kill(e)
                n_removed += 1
        progressed = n_removed > n_before
        g, v_space = hv.to_graph()
        if progressed:
            g = recondense(g, v_space)
    return g, v_space, n_removed


def _conj_vertex(hv: HostGraph, v: int) -> int | None:
    """Conjugate vertex id: via any incident edge's conjugate
    (the reference's g.conjugate(VertexId))."""
    for e in hv.out_edges(v):
        return int(hv.end_v[hv.conj[e]])
    for e in hv.in_edges(v):
        return int(hv.start_v[hv.conj[e]])
    return None


def _recondensed(hv: HostGraph, n: int) -> tuple[Graph, int, int]:
    g, vs = hv.to_graph()
    if n:
        g = recondense(g, vs)
    return g, vs, n


def remove_tr_ec(g: Graph, v_space: int, *,
                 max_ec_length: int,
                 uniqueness_length: int = 1500,
                 unreliable_coverage: float = 2.5
                 ) -> tuple[Graph, int, int]:
    """Topology-and-reliable-coverage EC removal
    (TopologyReliabilityRemoveErroneousEdges,
    single_cell_simplification.hpp:99-116 + trec block,
    simplification.info:212-217): a short low-coverage edge hanging off
    a junction whose single flank edge lies on a unique path >=
    uniqueness_length, with any other edge at the junction (plausibility
    AlwaysTrue), is removed in length order with the
    alternatives-presence guard. Returns (graph, v_space, n)."""
    hv = HostGraph(g, v_space)
    n_removed = 0
    for e in _by_length(hv):
        e = int(e)
        if (not hv.alive[e] or hv.len_k(e) > max_ec_length
                or hv.cov[e] >= unreliable_coverage
                or not _has_alternatives(hv, e)):
            continue
        if any(_unique_flank(hv, e, uniqueness_length, fwd)
               and _siblings(hv, e, fwd) for fwd in (True, False)):
            hv.kill(e)
            n_removed += 1
    return _recondensed(hv, n_removed)


def remove_thorns(g: Graph, v_space: int, *,
                  max_ec_length: int,
                  uniqueness_length: int = 1500,
                  span_distance: int = 15000) -> tuple[Graph, int, int]:
    """Interstrand EC ("thorn") removal (RemoveThorns,
    single_cell_simplification.hpp:78-97 + isec block,
    simplification.info:220-225): MDA chimeras connecting a repeat
    instance to the reverse strand. Candidate short edges are processed
    in coverage order; a thorn must pass TopologicalThornCondition
    (erroneous_connection_remover.hpp:201-251: 1-in/2-out at the start,
    2-in/1-out at the end, and a path of length <= span_distance from
    the start to the conjugate of the end vertex) and
    AdditionalMDAThornCondition (:253-310: a unique long flank, or every
    short incident alternative at least 15x its coverage). Returns
    (graph, v_space, n)."""
    hv = HostGraph(g, v_space)
    ids = np.nonzero(hv.alive)[0]
    order = ids[np.argsort(hv.cov[ids], kind="stable")]

    def degree_ok(e: int) -> bool:
        vs_, ve_ = int(hv.start_v[e]), int(hv.end_v[e])
        if vs_ == ve_:
            return False
        return (len(hv.out_edges(vs_)) == 2
                and len(hv.in_edges(vs_)) == 1
                and len(hv.out_edges(ve_)) == 1
                and len(hv.in_edges(ve_)) == 2)

    def span_path_exists(e: int) -> bool:
        # bounded Dijkstra EdgeStart(e) -> conjugate(EdgeEnd(e)) within
        # span_distance (ProcessPaths in TopologicalThornCondition)
        vs_ = int(hv.start_v[e])
        target = _conj_vertex(hv, int(hv.end_v[e]))
        if target is None:
            return False
        if vs_ == target:
            return True
        dist = {vs_: 0}
        heap = [(0, vs_)]
        seen = 0
        while heap and seen < 4096:
            seen += 1
            d, v = heapq.heappop(heap)
            if d > dist.get(v, 1 << 60):
                continue
            for o in hv.out_edges(v):
                nd = d + hv.len_k(o)
                if nd > span_distance:
                    continue
                w = int(hv.end_v[o])
                if w == target:
                    return True
                if nd < dist.get(w, 1 << 60):
                    dist[w] = nd
                    heapq.heappush(heap, (nd, w))
        return False

    def unique_flank(e: int) -> bool:
        ins = hv.in_edges(int(hv.start_v[e]))
        if len(ins) == 1 and hv.len_k(ins[0]) >= uniqueness_length:
            return True
        # CheckUnique(conjugate(EdgeEnd(e))): unique incoming at the
        # conjugate vertex == unique outgoing at the end vertex
        outs = hv.out_edges(int(hv.end_v[e]))
        return len(outs) == 1 and hv.len_k(outs[0]) >= uniqueness_length

    def ec_around(e: int) -> bool:
        base_cov = max(hv.cov[e], 1e-9)
        for v in (int(hv.start_v[e]), int(hv.end_v[e])):
            for o in hv.incident(v):
                if o != e and hv.len_k(o) < 400 \
                        and hv.cov[o] / base_cov < 15.0:
                    return False
        return True

    n_removed = 0
    for e in order:
        e = int(e)
        if not hv.alive[e] or hv.len_k(e) > max_ec_length \
                or not _has_alternatives(hv, e) or not degree_ok(e):
            continue
        if not (unique_flank(e) or ec_around(e)):
            continue
        # micro-shortcut: conjugate(EdgeStart) == EdgeEnd passes without
        # the path search (erroneous_connection_remover.hpp:238-240)
        vs_, ve_ = int(hv.start_v[e]), int(hv.end_v[e])
        if _conj_vertex(hv, vs_) == ve_ or span_path_exists(e):
            hv.kill(e)
            n_removed += 1
    return _recondensed(hv, n_removed)


def _multiplicity_count(hv: HostGraph, e: int, start: int,
                        uniqueness_length: int,
                        max_depth: int = 8) -> int:
    """MultiplicityCounter::count
    (topological_edge_conditions.hpp:166-244): balance of unique long
    incoming vs outgoing edges reachable from ``start`` through short
    edges, skipping ``e``; a large sentinel when undecidable."""
    INVALID = 1 << 30
    result = [0, 0]  # [unique long incoming, unique long outgoing]
    was: set[int] = set()

    def search(a: int, depth: int) -> bool:
        if depth > max_depth:
            return False
        if a in was:
            return True
        was.add(a)
        if not hv.out_edges(a) or not hv.in_edges(a):
            return False
        for o in hv.out_edges(a):
            if o == e:
                if a != start:
                    return False
            elif hv.len_k(o) >= uniqueness_length:
                result[1] += 1
            elif not search(int(hv.end_v[o]), depth + 1):
                return False
        for i in hv.in_edges(a):
            if i == e:
                if a != start:
                    return False
            elif hv.len_k(i) >= uniqueness_length:
                result[0] += 1
            elif not search(int(hv.start_v[i]), depth + 1):
                return False
        return True

    if not search(start, 0):
        return INVALID
    if int(hv.start_v[e]) == start:
        if result[0] < result[1]:
            return INVALID
        return result[0] - result[1]
    if result[0] > result[1]:
        return INVALID
    return result[1] - result[0]


def remove_multiplicity_ec(g: Graph, v_space: int, *,
                           max_ec_length: int,
                           uniqueness_length: int = 1500,
                           plausibility_length: int = 200
                           ) -> tuple[Graph, int, int]:
    """Multiplicity-counting EC removal
    (MultiplicityCountingRemoveErroneousEdges,
    single_cell_simplification.hpp:60-76 + MultiplicityCountingCondition,
    topological_edge_conditions.hpp:247-283): the junction's flank is
    unique when counting the unique long edges around it gives
    multiplicity <= 1 (counted from the flank edge's far endpoint);
    plausibility is the bounded plausible-path check. Length-ordered with
    the alternatives-presence guard. Returns (graph, v_space, n)."""
    hv = HostGraph(g, v_space)

    def unique(e: int, forward: bool) -> bool:
        flank = (hv.in_edges(int(hv.start_v[e])) if forward
                 else hv.out_edges(int(hv.end_v[e])))
        if len(flank) != 1:
            return False
        far = (int(hv.start_v[flank[0]]) if forward
               else int(hv.end_v[flank[0]]))
        return _multiplicity_count(hv, flank[0], far,
                                   uniqueness_length) <= 1

    n_removed = 0
    for e in _by_length(hv):
        e = int(e)
        if not hv.alive[e] or hv.len_k(e) > max_ec_length \
                or not _has_alternatives(hv, e):
            continue
        if any(unique(e, fwd) and any(
                _plausible_path_len(hv, o, 2 * plausibility_length, fwd)
                >= plausibility_length for o in _siblings(hv, e, fwd))
               for fwd in (True, False)):
            hv.kill(e)
            n_removed += 1
    return _recondensed(hv, n_removed)


# ---------------------------------------------------------------------
# Hidden-EC removers
# ---------------------------------------------------------------------

def remove_hidden_ec(g: Graph, v_space: int, *,
                     uniqueness_length: int = 1500,
                     unreliability_threshold: float = 4.0,
                     ec_threshold: float = 1e18,
                     relative_threshold: float = 5.0,
                     meta: bool = False) -> tuple[Graph, int, int]:
    """Hidden-EC removal at suspicious vertices (1 in-edge, 2 out-edges,
    unique long in-path): disconnect the weaker-flank out-edge, or both
    (HiddenECRemover erroneous_connection_remover.hpp:499; the meta
    variant :414 requires the two out-edges to be mutually conjugate and
    ignores the unreliability and ec thresholds). Returns (graph,
    v_space, n)."""
    hv = HostGraph(g, v_space)
    n = 0
    for v in sorted({int(x) for x in hv.start_v[hv.alive]}):
        outs = hv.out_edges(v)
        ins = hv.in_edges(v)
        if len(ins) != 1 or len(outs) != 2:
            continue
        conj_pair = int(hv.conj[outs[0]]) == outs[1]
        if meta:
            if not conj_pair or _unique_path_len_lower_bound(
                    hv, ins[0], uniqueness_length) < uniqueness_length:
                continue
        elif not (conj_pair or hv.len_k(ins[0]) >= uniqueness_length):
            continue
        e1, e2 = sorted(outs, key=lambda x: hv.local_cov(x, v))
        c1, c2 = hv.local_cov(e1, v), hv.local_cov(e2, v)
        if meta:
            if c1 * relative_threshold < c2:
                hv.disconnect_start(e1, trim=hv.k + 1)
            else:
                hv.disconnect_all_out(v)
            n += 1
        elif c2 < unreliability_threshold:
            hv.disconnect_all_out(v)
            n += 1
        elif c1 * relative_threshold < c2 and c1 < ec_threshold:
            hv.disconnect_start(e1, trim=hv.k + 1)
            n += 1
    gg, vs = hv.to_graph()
    return gg, vs, n
