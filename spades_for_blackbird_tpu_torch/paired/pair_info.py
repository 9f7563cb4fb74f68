"""Paired-info index: (edge1, edge2) -> histogram of (distance, weight).

PyTorch counterpart of the JAX package's ``paired/pair_info.py``
(the reference's ``PairedIndex``, common/paired_info/
paired_info.hpp:24-660, and ``LatePairedIndexFiller``,
pair_info_filler.hpp): the unclustered index is one sorted table of
(e1, e2, d) observations built by a sort and a run-length count; the
distance estimators reduce it per (e1, e2) group; split-path filling and
the merge of libraries then run on the host, as in the JAX package.

Distance convention (the reference's left-start to left-start points,
index_point.hpp): an observation from a mate pair says oriented edge
e2's start lies ``d`` bases right of oriented edge e1's start:
d = start1 - start2 + IS_shift, with IS_shift = insert_size - len(r2)
applied by the caller.

Where the JAX package sorts three uint32 words (e1, e2, d + 2^24), the
port sorts two int64 keys, ``e1 << 32 | e2`` and ``d + 2^24``, in the
same order (|d| < 2^24 bases). The estimators' sums of ``weight``,
``weight * d`` and ``weight * d^2`` are float32 additions in the JAX
package (XLA adds them in row order); here each term is the same float32
product, and the terms are summed exactly in float64 and rounded to
float32 once, so the card and the CPU give the same bits. ``dist`` and
``weight`` then equal the JAX package's wherever its float32 running
sums are exact; ``var``, a difference of two such sums, can differ in
its last bits (tests/test_torch_paired.py states the tolerance).
"""

from __future__ import annotations

import heapq
from typing import NamedTuple

import numpy as np
import torch

from ..graph.host import edge_mask, host_view
from ..ops import segments
from ..utils import membudget


class PairedIndex(NamedTuple):
    """Sorted unique (e1, e2, d) rows with weights; ``num`` rows are real.

    Built on a device its fields are tensors there; the host passes
    (``split_path_fill``, ``merge_paired_indices``, path extension) hold
    NumPy arrays (``host_index``). ``var`` is the clustered-point
    distance variance (index_point.hpp:221 PointT.var): raw indices carry
    None, the estimators fill it with the weighted spread of the merged
    observations.
    """
    e1: torch.Tensor | np.ndarray       # (N,) oriented edge ids
    e2: torch.Tensor | np.ndarray       # (N,)
    dist: torch.Tensor | np.ndarray     # (N,) int
    weight: torch.Tensor | np.ndarray   # (N,) float32
    num: torch.Tensor | int             # rows that are real
    var: torch.Tensor | np.ndarray | None = None  # (N,) float32

    @property
    def capacity(self) -> int:
        return self.e1.shape[0]


_DIST_BIAS = 1 << 24
_LOW32 = 0xFFFFFFFF


def host_index(idx: PairedIndex) -> PairedIndex:
    """The index with NumPy fields (the JAX package's dtypes) and an int
    ``num``; an index on the host already comes back as it is."""
    if isinstance(idx.e1, np.ndarray):
        return idx

    def pull(t, dtype):
        return t.cpu().numpy().astype(dtype)
    return PairedIndex(
        e1=pull(idx.e1, np.int32), e2=pull(idx.e2, np.int32),
        dist=pull(idx.dist, np.int32), weight=pull(idx.weight, np.float32),
        num=int(idx.num),
        var=None if idx.var is None else pull(idx.var, np.float32))


def _pair_rows(m1, m2rc, is_shift: int):
    """(e1, e2, d) of every observation of one chunk of read pairs, from
    CHAIN mappings (mapper.ChainMapping): each placement of mate 1 against
    each of mate 2, then each ordered pair of placements of one mate
    (split-read threading, shift 0). Only mapped placements are kept."""
    ok1 = (m1.oriented_edge >= 0) & m1.mapped[:, None]
    ok2 = (m2rc.oriented_edge >= 0) & m2rc.mapped[:, None]
    okx = ok1[:, :, None] & ok2[:, None, :]
    e1 = [m1.oriented_edge[:, :, None].expand(okx.shape)[okx]]
    e2 = [m2rc.oriented_edge[:, None, :].expand(okx.shape)[okx]]
    d = [(m1.start[:, :, None] - m2rc.start[:, None, :] + is_shift)[okx]]
    C = m1.oriented_edge.shape[1]
    for m, ok in ((m1, ok1), (m2rc, ok2)):
        for i in range(C - 1):
            for j in range(i + 1, C):
                both = ok[:, i] & ok[:, j]
                e1.append(m.oriented_edge[both, i])
                e2.append(m.oriented_edge[both, j])
                d.append(m.start[both, i] - m.start[both, j])
    return torch.cat(e1), torch.cat(e2), torch.cat(d)


def _count_rows(e1, e2, d) -> PairedIndex:
    """Sort and run-length count (e1, e2, d) rows (all real)."""
    hi = (e1 << 32) | e2
    lo = (d + _DIST_BIAS) & _LOW32
    perm = segments.lexsort_perm([hi, lo])
    hi, lo = hi[perm], lo[perm]
    first = torch.nonzero(segments.run_heads([hi, lo])).flatten()
    counts = torch.diff(first, append=first.new_full((1,), hi.shape[0]))
    hi, lo = hi[first], lo[first]
    # the key back to an int32 distance, as the JAX package reads it
    dist = lo - ((lo >> 31) << 32) - _DIST_BIAS
    return PairedIndex(e1=hi >> 32, e2=hi & _LOW32, dist=dist,
                       weight=counts.to(torch.float32),
                       num=torch.tensor(first.shape[0], device=hi.device))


def fill_paired_index(m1, m2rc, is_shift: int) -> PairedIndex:
    """The unclustered paired index from single placements
    (mapper.ReadMapping): one observation a pair whose mates both
    mapped. m1: first mates; m2rc: reverse-complemented second mates
    (both oriented downstream); is_shift: insert_size - read2_len.
    Same-edge pairs are kept (the reference stores self-pairs too)."""
    ok = m1.mapped & m2rc.mapped
    return _count_rows(m1.oriented_edge[ok], m2rc.oriented_edge[ok],
                       (m1.start - m2rc.start + int(is_shift))[ok])


def fill_paired_index_multi(m1, m2rc, is_shift: int) -> PairedIndex:
    """Paired index from CHAIN mappings (mapper.ChainMapping).

    Mirrors the reference's LatePairedIndexFiller over MappingPaths
    (pair_info_filler.hpp: every (edge of path1, edge of path2)
    combination gets a point) plus rnaSPAdes' split-read threading
    (pair_info_count.cpp split-read paths): consecutive placements of
    ONE read are junction-crossing evidence and enter the same index as
    zero-shift pairs. m1: first mates; m2rc: reverse-complemented second
    mates (both oriented downstream); is_shift: insert_size - read2_len.
    """
    return _count_rows(*_pair_rows(m1, m2rc, int(is_shift)))


def pair_chunk_reads(max_placements: int, device: torch.device) -> int:
    """Read pairs one chunk of ``fill_paired_index_multi_chunked`` holds:
    C*C + C*(C-1) candidate rows a pair, each three int64 columns, a mask
    and the sort's keys and permutation, 96 bytes a row."""
    C = max_placements
    return membudget.reads_per_chunk(96 * (C * C + C * (C - 1)), device,
                                     1 << 16)


def pair_rows_chunked(ch1, ch2, is_shift: int, chunk: int | None = None):
    """``_pair_rows`` over chunks of read pairs, the candidate rows of
    each chunk masked there: the kept (e1, e2, d) rows of all chunks."""
    R = ch1.oriented_edge.shape[0]
    if chunk is None:
        chunk = pair_chunk_reads(ch1.oriented_edge.shape[1],
                                 ch1.oriented_edge.device)
    if R <= chunk:
        return _pair_rows(ch1, ch2, int(is_shift))
    parts = [_pair_rows(type(ch1)(*(f[lo:lo + chunk] for f in ch1)),
                        type(ch2)(*(f[lo:lo + chunk] for f in ch2)),
                        int(is_shift))
             for lo in range(0, R, chunk)]
    return tuple(torch.cat(cols) for cols in zip(*parts))


def fill_paired_index_multi_chunked(ch1, ch2, is_shift: int,
                                    chunk: int | None = None
                                    ) -> PairedIndex:
    """``fill_paired_index_multi`` over chunks of read pairs: the rows
    of every chunk (``pair_rows_chunked``) counted in one sort. Counts
    are integers, so the chunk size changes nothing in the result."""
    return _count_rows(*pair_rows_chunked(ch1, ch2, is_shift, chunk))


def _groups(e1, e2, extra_break=None):
    """Group id of every row (rows sorted by (e1, e2, ...)), a new group
    where (e1, e2) changes or ``extra_break`` is set; and the first row
    of each group."""
    head = segments.run_heads([e1, e2])
    if extra_break is not None:
        head |= extra_break
    return torch.cumsum(head, 0) - 1, torch.nonzero(head).flatten()


def _moments(gid, n_groups: int, rows, weight, dist):
    """Per-group sums of ``weight``, ``weight * d`` and ``weight * d^2``
    over ``rows``: each term the float32 product the JAX package adds,
    the sum exact (float64 of integer-valued terms), rounded to float32
    once. Then (wsum, dmean, dvar) in float32, as the JAX package derives
    them."""
    df = dist.to(torch.float32)
    terms = torch.stack([weight, weight * df, weight * torch.square(df)], 1)
    sums = torch.zeros((n_groups, 3), dtype=torch.float64,
                       device=weight.device)
    segments.index_add_float(sums, gid[rows], terms[rows].to(torch.float64))
    wsum, dsum, d2sum = sums.to(torch.float32).unbind(1)
    denom = torch.clamp(wsum, min=1e-9)
    dmean = torch.where(wsum > 0, dsum / denom, 0.0)
    dvar = torch.clamp(torch.where(wsum > 0, d2sum / denom, 0.0)
                       - torch.square(dmean), min=0.0)
    return wsum, dmean, dvar


def cluster_distances(idx: PairedIndex, max_spread: int) -> PairedIndex:
    """Collapse raw observations into per-(e1,e2) distance estimates.

    Simplified analogue of the reference's DistanceEstimator
    (paired_info/distance_estimation.cpp:97 EstimateEdgePairDistances):
    per (e1, e2) group, observations within ``max_spread`` of the weighted
    mode merge into one point at the weighted mean with summed weight;
    observations far from the mode are dropped (contradiction cleaning,
    pair_info_filters.hpp).
    """
    n = int(idx.num)
    e1, e2, dist, w = idx.e1[:n], idx.e2[:n], idx.dist[:n], idx.weight[:n]
    gid, first = _groups(e1, e2)
    G = first.shape[0]
    # weighted mode per group: the smallest distance of the heaviest rows
    best_w = torch.zeros(G, dtype=w.dtype, device=w.device).scatter_reduce_(
        0, gid, w, "amax")
    is_mode = w == best_w[gid]
    mode_d = torch.full((G,), 1 << 30, dtype=dist.dtype,
                        device=w.device).scatter_reduce_(
        0, gid[is_mode], dist[is_mode], "amin")
    near = torch.abs(dist - mode_d[gid]) <= max_spread
    wsum, dmean, dvar = _moments(gid, G, near, w, dist)
    return PairedIndex(e1=e1[first], e2=e2[first],
                       dist=torch.round(dmean).to(torch.int64),
                       weight=wsum, num=torch.tensor(G, device=w.device),
                       var=dvar)


def cluster_distances_smoothing(idx: PairedIndex, max_gap: int,
                                min_weight: float) -> PairedIndex:
    """Multi-peak distance estimation for wide-insert (mate-pair) data.

    Counterpart of the reference's smoothing estimator
    (paired_info/smoothing_distance_estimation.hpp:19 +
    data_divider.hpp + peak_finder.hpp): within each (e1, e2) group the
    sorted distance observations are divided wherever consecutive
    distances differ by more than ``max_gap`` (DataDivider), and every
    cluster above ``min_weight`` becomes one estimated point at its
    weighted mean (the peak). Unlike :func:`cluster_distances` this
    keeps several peaks per edge pair.
    """
    n = int(idx.num)
    e1, e2, dist, w = idx.e1[:n], idx.e2[:n], idx.dist[:n], idx.weight[:n]
    gap_break = torch.zeros(n, dtype=torch.bool, device=w.device)
    if n:
        gap_break[1:] = (dist[1:] - dist[:-1]) > max_gap
    cid, first = _groups(e1, e2, gap_break)
    n_clusters = first.shape[0]
    every = torch.ones(n, dtype=torch.bool, device=w.device)
    wsum, dmean, dvar = _moments(cid, n_clusters, every, w, dist)
    keep = wsum >= torch.tensor(min_weight, dtype=torch.float32)
    first = first[keep]
    return PairedIndex(e1=e1[first], e2=e2[first],
                       dist=torch.round(dmean[keep]).to(torch.int64),
                       weight=wsum[keep],
                       num=torch.tensor(first.shape[0], device=w.device),
                       var=dvar[keep])


class _KeySpace:
    """Monotone (e1, e2, d) -> int64 composite keys with data-dependent
    field widths, so edge-id and distance ranges never silently collide
    (meta graphs can exceed 2^20 edges; distances are signed)."""

    def __init__(self, e_max: int, d_min: int, d_max: int):
        self.e_bits = max(int(e_max).bit_length(), 1)
        self.d_off = int(d_min)
        self.d_bits = max(int(d_max - d_min + 1).bit_length(), 1)
        if 2 * self.e_bits + self.d_bits > 62:
            raise ValueError("paired-index key space exceeds 62 bits")

    def key(self, e1, e2, d):
        return (((e1.astype(np.int64) << self.e_bits)
                 | e2.astype(np.int64)) << self.d_bits) \
            | (d.astype(np.int64) - self.d_off)


def _from_arrays(e1, e2, d, w, capacity, var=None) -> PairedIndex:
    """A host PairedIndex of ``capacity`` rows (at least ``len(e1)``)."""
    n = len(e1)
    cap = max(int(capacity), n)
    E1 = np.zeros(cap, np.int32); E1[:n] = e1
    E2 = np.zeros(cap, np.int32); E2[:n] = e2
    D = np.zeros(cap, np.int32); D[:n] = d
    W = np.zeros(cap, np.float32); W[:n] = w
    V = None
    if var is not None:
        V = np.zeros(cap, np.float32); V[:n] = var
    return PairedIndex(e1=E1, e2=E2, dist=D, weight=W, num=n, var=V)


def improve_pair_info(idx: PairedIndex, max_spread: int = 10,
                      weight_coeff: float = 0.5) -> PairedIndex:
    """Aggressive transitive closure: (A,B,d1) + (B,C,d2) implies
    (A,C,d1+d2); missing implied points are added with weight
    ``weight_coeff * min(w1, w2)``, existing nearby points (within
    ``max_spread``) are left alone.

    NOTE: this is NOT the reference improver's FillMissing — that only
    derives points along forced graph paths (see :func:`split_path_fill`,
    which the pipeline uses). Blind transitive joins through a repeat
    edge B fabricate cross-copy links (A -> B(copy1), B(copy2) -> C
    implies a false A -> C) and are only safe on repeat-free graphs.

    Host-side but fully vectorized: the B-join is a sorted-array
    range join (searchsorted + repeat), the near-existing check a
    single searchsorted on the composite (e1,e2,d) key — no Python
    loops, so it survives real-genome-sized clustered indices. An index
    on a device is pulled to the host first (``host_index``); the result
    is a host index.
    """
    idx = host_index(idx)
    n = int(idx.num)
    e1 = np.asarray(idx.e1)[:n].astype(np.int64)
    e2 = np.asarray(idx.e2)[:n].astype(np.int64)
    d = np.asarray(idx.dist)[:n].astype(np.int64)
    w = np.asarray(idx.weight)[:n].astype(np.float64)
    if n == 0:
        return idx

    # rows are sorted by (e1, e2, d) already (count_sorted invariant);
    # join i->j on e2[i] == e1[j]
    lo = np.searchsorted(e1, e2, side="left")
    hi = np.searchsorted(e1, e2, side="right")
    cnt = hi - lo
    total = int(cnt.sum())
    if total == 0:
        return idx
    rows_i = np.repeat(np.arange(n), cnt)
    # concatenated ranges lo[i] .. hi[i): offset trick
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    rows_j = (np.arange(total) - np.repeat(starts, cnt)
              + np.repeat(lo, cnt))

    a = e1[rows_i]
    c = e2[rows_j]
    dd = d[rows_i] + d[rows_j]
    ww = weight_coeff * np.minimum(w[rows_i], w[rows_j])
    keep = a != c
    a, c, dd, ww = a[keep], c[keep], dd[keep], ww[keep]
    if len(a) == 0:
        return idx

    # drop candidates with an existing point within max_spread: the
    # first existing row >= (a, c, dd - spread) is within spread iff
    # its composite key <= (a, c, dd + spread)
    ks = _KeySpace(max(int(e1.max()), int(e2.max())),
                   min(int(d.min()), int(dd.min()) - max_spread),
                   max(int(d.max()), int(dd.max()) + max_spread))
    comp_exist = ks.key(e1, e2, d)
    pos = np.searchsorted(comp_exist, ks.key(a, c, dd - max_spread))
    upper = ks.key(a, c, dd + max_spread)
    near = (pos < n) & (comp_exist[np.minimum(pos, n - 1)] <= upper)
    a, c, dd, ww = a[~near], c[~near], dd[~near], ww[~near]
    if len(a) == 0:
        return idx

    # dedup candidates by (a, c, dd), keep max weight
    comp_new = ks.key(a, c, dd)
    order = np.lexsort((-ww, comp_new))
    comp_new, a, c, dd, ww = (comp_new[order], a[order], c[order],
                              dd[order], ww[order])
    first = np.concatenate([[True], comp_new[1:] != comp_new[:-1]])
    a, c, dd, ww = a[first], c[first], dd[first], ww[first]

    E1 = np.concatenate([e1, a])
    E2 = np.concatenate([e2, c])
    D = np.concatenate([d, dd])
    W = np.concatenate([w, ww])
    order = np.argsort(ks.key(E1, E2, D), kind="stable")
    return _from_arrays(E1[order], E2[order], D[order], W[order],
                        idx.capacity)


def split_path_fill(g, idx: PairedIndex, is_mean: float, is_dev: float,
                    max_spread: int = 10,
                    weight_coeff: float = 0.5) -> PairedIndex:
    """Split-path pair-info derivation (the FillMissing half of the
    reference's PairInfoImprover, pair_info_improver.hpp:215 +
    split_path_constructor.hpp:74 ConvertPIToSplitPaths): a point
    (e1, e2, d) implies points (e1, m, d - dist(m..e2)) for every edge
    ``m`` on the common suffix that ALL e1->e2 paths of length ~d must
    traverse. The common suffix is the unique-predecessor chain walked
    back from e2 (bounded by the insert-size path upper bound).

    Host NumPy over the clustered index (one row per nearby edge pair),
    as in the JAX package; the graph and the index are copied to the
    host once. Returns a host index.
    """
    import heapq

    idx = host_index(idx)
    n = int(idx.num)
    if n == 0:
        return idx
    g = host_view(g)
    alive = edge_mask(g)
    start_v = g.start_v
    end_v = g.end_v
    seq_len = g.seq_len
    k = g.k
    len_k = seq_len - k
    in_of: dict[int, list[int]] = {}
    for e in np.nonzero(alive)[0]:
        in_of.setdefault(int(end_v[e]), []).append(int(e))

    e1 = np.asarray(idx.e1)[:n]
    e2 = np.asarray(idx.e2)[:n]
    d = np.asarray(idx.dist)[:n]
    w = np.asarray(idx.weight)[:n]
    upper = int(is_mean + 2 * max(is_dev, 1.0))  # PairInfoPathLengthUpperBound

    out_of: dict[int, list[int]] = {}
    for e in np.nonzero(alive)[0]:
        out_of.setdefault(int(start_v[e]), []).append(int(e))

    dij_cache: dict[int, dict[int, int]] = {}

    def reach_from(src_v: int) -> dict[int, int]:
        """Bounded Dijkstra vertex distances from ``src_v`` (the
        reference's CreateBoundedDijkstra run from EdgeEnd(e1))."""
        got = dij_cache.get(src_v)
        if got is not None:
            return got
        best = {src_v: 0}
        q = [(0, src_v)]
        while q:
            dist, v = heapq.heappop(q)
            if dist > best.get(v, 1 << 30):
                continue
            for e in out_of.get(v, []):
                nd = dist + int(len_k[e])
                t = int(end_v[e])
                if nd <= upper and nd < best.get(t, 1 << 30):
                    best[t] = nd
                    heapq.heappush(q, (nd, t))
        dij_cache[src_v] = best
        return best

    add_e1, add_e2, add_d, add_w = [], [], [], []
    for i in range(n):
        a, b, dd, ww = int(e1[i]) // 2, int(e2[i]) // 2, int(d[i]), w[i]
        if dd <= 0 or a == b or dd > upper:
            continue
        # walk back from e2 through the predecessors every a->b path of
        # length ~dd must traverse: candidate predecessors are filtered
        # by reachability from end(e1) (GetCommonPathsEnd semantics)
        reach = reach_from(int(end_v[a]))
        total = 0
        v = int(start_v[b])
        if v not in reach:
            continue
        while True:
            ins = [m for m in in_of.get(v, [])
                   if int(start_v[m]) in reach
                   and reach[int(start_v[m])] + int(len_k[m]) + total
                   <= dd + 2 * int(max(is_dev, 1.0))]
            if len(ins) != 1:
                break
            m = ins[0]
            total += int(len_k[m])
            if total >= dd or m == a:
                break
            add_e1.append(2 * a)
            add_e2.append(2 * m)
            add_d.append(dd - total)
            add_w.append(weight_coeff * ww)
            v = int(start_v[m])
    if not add_e1:
        return idx
    # merge derived points, but never override nearby existing evidence:
    # drop candidates with an existing point within max_spread first
    a = np.asarray(add_e1, np.int64)
    c = np.asarray(add_e2, np.int64)
    dd = np.asarray(add_d, np.int64)
    ww = np.asarray(add_w, np.float64)
    e1a = e1.astype(np.int64)
    e2a = e2.astype(np.int64)
    da = d.astype(np.int64)
    ks = _KeySpace(max(int(e1a.max()), int(e2a.max()), int(a.max()),
                       int(c.max()), 1),
                   min(int(da.min()), int(dd.min()) - max_spread),
                   max(int(da.max()), int(dd.max()) + max_spread))
    comp_exist = ks.key(e1a, e2a, da)
    pos = np.searchsorted(comp_exist, ks.key(a, c, dd - max_spread))
    near = (pos < n) & (comp_exist[np.minimum(pos, n - 1)]
                        <= ks.key(a, c, dd + max_spread))
    a, c, dd, ww = a[~near], c[~near], dd[~near], ww[~near]
    if len(a) == 0:
        return idx
    # dedup derived candidates by (a, c, dd), keep max weight
    comp_new = ks.key(a, c, dd)
    order = np.lexsort((-ww, comp_new))
    comp_new, a, c, dd, ww = (comp_new[order], a[order], c[order],
                              dd[order], ww[order])
    first = np.concatenate([[True], comp_new[1:] != comp_new[:-1]])
    a, c, dd, ww = a[first], c[first], dd[first], ww[first]
    E1 = np.concatenate([e1a, a])
    E2 = np.concatenate([e2a, c])
    D = np.concatenate([da, dd])
    W = np.concatenate([w.astype(np.float64), ww])
    order = np.argsort(ks.key(E1, E2, D), kind="stable")
    return _from_arrays(E1[order], E2[order], D[order], W[order],
                        idx.capacity)


def merge_paired_indices(indices: list[PairedIndex]) -> PairedIndex:
    """Merge clustered indices from multiple libraries into one host
    table, summing weights of identical (e1, e2, d) rows (the reference
    keeps ``PairedIndices`` per lib, paired_info.hpp:659; scaffolding
    joins pool evidence across libraries). Vectorized sort + run-length
    sum."""
    indices = [host_index(i) for i in indices]
    if len(indices) == 1:
        return indices[0]
    parts = [(np.asarray(i.e1)[:int(i.num)], np.asarray(i.e2)[:int(i.num)],
              np.asarray(i.dist)[:int(i.num)],
              np.asarray(i.weight)[:int(i.num)],
              np.asarray(i.var)[:int(i.num)] if i.var is not None
              else np.zeros(int(i.num), np.float32)) for i in indices]
    e1 = np.concatenate([p[0] for p in parts]).astype(np.int64)
    e2 = np.concatenate([p[1] for p in parts]).astype(np.int64)
    d = np.concatenate([p[2] for p in parts]).astype(np.int64)
    w = np.concatenate([p[3] for p in parts]).astype(np.float64)
    v = np.concatenate([p[4] for p in parts]).astype(np.float64)
    cap = max((i.capacity for i in indices), default=1)
    if len(e1) == 0:
        return _from_arrays(e1, e2, d, w, cap, var=v)
    ks = _KeySpace(max(int(e1.max()), int(e2.max()), 1),
                   int(d.min()), int(d.max()))
    comp = ks.key(e1, e2, d)
    order = np.argsort(comp, kind="stable")
    comp, e1, e2 = comp[order], e1[order], e2[order]
    d, w, v = d[order], w[order], v[order]
    first = np.concatenate([[True], comp[1:] != comp[:-1]])
    gid = np.cumsum(first) - 1
    wsum = np.zeros(int(gid[-1]) + 1, np.float64)
    np.add.at(wsum, gid, w)
    # pooled variance of identical-distance points: weight-averaged
    # (the reference widens merged bounds by +-var, index_point.hpp:244)
    vsum = np.zeros(int(gid[-1]) + 1, np.float64)
    np.add.at(vsum, gid, w * v)
    vmerged = vsum / np.maximum(wsum, 1e-9)
    return _from_arrays(e1[first], e2[first], d[first], wsum, cap,
                        var=vmerged)


def weighted_cluster_distances(g, idx: PairedIndex, is_hist: dict,
                               is_mean: float, is_dev: float,
                               max_distance: int | None = None
                               ) -> PairedIndex:
    """Weighted distance estimation with graph-distance snapping.

    The reference's WeightedDistanceEstimator
    (paired_info/weighted_distance_estimation.cpp:8-60) driven the way
    estimate_scaffolding_distance drives its smoothing sibling
    (projects/spades/distance_estimation.cpp:100-135): candidate
    distances between an edge pair are the actual GRAPH path lengths
    (GraphDistanceFinder), each raw observation (d, w) snaps to its
    nearest candidate within ``max_distance``, contributing
    ``w * weight_f(candidate - d)`` where weight_f is the library's
    normalized insert-size distribution (WeightDEWrapper.CountWeight,
    paired_info/pair_info_bounds.hpp).  Pairs with no graph path in
    range keep their plain weighted-mean point (the estimator's
    fallback of emitting the histogram as-is).

    ``idx`` is a RAW (unclustered) index over forward oriented ids, on
    a device or the host. Host-side over edge-pair groups, on one copy of
    the graph (``host_view``); Dijkstra results are cached per source
    vertex like split_path_fill's. Returns a host index.
    """
    n = int(idx.num)
    if n == 0:
        return host_index(cluster_distances(idx, max(5, int(3 * is_dev))))
    idx = host_index(idx)
    if max_distance is None:
        max_distance = max(int(2 * is_dev), 10)

    # normalized IS-shift weight function (WeightDEWrapper): the
    # distribution of (observed distance - expected distance)
    total = float(sum(is_hist.values())) or 1.0
    wf = {int(round(size - is_mean)): cnt / total
          for size, cnt in is_hist.items()}

    def weight_f(delta: int) -> float:
        # nearest-bin lookup with light smearing over +-2
        acc, norm = 0.0, 0
        for o in range(-2, 3):
            acc += wf.get(delta + o, 0.0)
            norm += 1
        return max(acc / norm, 1e-6)

    g = host_view(g)
    alive = edge_mask(g)
    start_v = g.start_v
    end_v = g.end_v
    len_k = g.seq_len - g.k
    out_of: dict[int, list[int]] = {}
    for e in np.nonzero(alive)[0]:
        out_of.setdefault(int(start_v[e]), []).append(int(e))

    e1 = np.asarray(idx.e1)[:n]
    e2 = np.asarray(idx.e2)[:n]
    d = np.asarray(idx.dist)[:n]
    w = np.asarray(idx.weight)[:n]
    upper = int(is_mean + 3 * max(is_dev, 1.0))

    # all path lengths (not just shortest) from a vertex, bounded
    lens_cache: dict[int, dict[int, set]] = {}

    def path_lengths_from(src_v: int) -> dict[int, set]:
        got = lens_cache.get(src_v)
        if got is not None:
            return got
        lens: dict[int, set] = {src_v: {0}}
        q = [(0, src_v)]
        seen = set()
        while q:
            dist, v = heapq.heappop(q)
            if (dist, v) in seen:
                continue
            seen.add((dist, v))
            if len(seen) > 4096:     # state cap for repeat tangles
                break
            for e in out_of.get(v, []):
                nd = dist + int(len_k[e])
                t = int(end_v[e])
                if nd <= upper:
                    s = lens.setdefault(t, set())
                    if nd not in s:
                        s.add(nd)
                        heapq.heappush(q, (nd, t))
        lens_cache[src_v] = lens
        return lens

    # group rows by (e1, e2): rows are sorted already
    E1o, E2o, Do, Wo, Vo = [], [], [], [], []
    i = 0
    while i < n:
        j = i
        while j < n and e1[j] == e1[i] and e2[j] == e2[i]:
            j += 1
        a, b = int(e1[i]) // 2, int(e2[i]) // 2
        ds = d[i:j].astype(np.int64)
        ws = w[i:j].astype(np.float64)
        if a == b:
            forward: list[int] = []
        else:
            lens = path_lengths_from(int(end_v[a]))
            # start-to-start distance = len_k(a) + interior path length
            forward = sorted(int(len_k[a]) + L
                             for L in lens.get(int(start_v[b]), ()))
        minD, maxD = int(ds.min()), int(ds.max())
        forward = [f for f in forward
                   if minD - max_distance <= f <= maxD + max_distance]
        if forward:
            fa = np.asarray(forward, np.int64)
            # nearest candidate per point (EstimateEdgePairDistances'
            # forward-march, distance_estimation.cpp:97-140)
            pos = np.searchsorted(fa, ds)
            left = np.clip(pos - 1, 0, len(fa) - 1)
            right = np.clip(pos, 0, len(fa) - 1)
            pick = np.where(np.abs(fa[right] - ds) < np.abs(ds - fa[left]),
                            right, left)
            snapped = fa[pick]
            ok = np.abs(snapped - ds) <= max_distance
            if ok.any():
                wsnap = ws[ok] * np.asarray(
                    [weight_f(int(dd)) for dd in (snapped - ds)[ok]])
                for f in np.unique(snapped[ok]):
                    sel = snapped[ok] == f
                    wt = float(wsnap[sel].sum())
                    if wt <= 0:
                        continue
                    src_d = ds[ok][sel].astype(np.float64)
                    sw = ws[ok][sel]
                    m = float((src_d * sw).sum() / sw.sum())
                    v = float((sw * (src_d - m) ** 2).sum() / sw.sum())
                    E1o.append(int(e1[i])); E2o.append(int(e2[i]))
                    Do.append(int(f)); Wo.append(wt); Vo.append(v)
                i = j
                continue
        # fallback: plain weighted mean of the group
        m = float((ds * ws).sum() / ws.sum())
        v = float((ws * (ds - m) ** 2).sum() / ws.sum())
        E1o.append(int(e1[i])); E2o.append(int(e2[i]))
        Do.append(int(round(m))); Wo.append(float(ws.sum())); Vo.append(v)
        i = j

    order = np.lexsort((Do, E2o, E1o))
    return _from_arrays(np.asarray(E1o)[order], np.asarray(E2o)[order],
                        np.asarray(Do)[order], np.asarray(Wo)[order],
                        idx.capacity, var=np.asarray(Vo)[order])
