"""Graph-based erroneous-connection threshold finder.

PyTorch counterpart of the JAX package's ``simplify/ec_threshold.py``
(the reference's uneven-coverage fallback,
modules/simplification/ec_threshold_finder.hpp:25
``ErroneousConnectionThresholdFinder``, consumed by GenomicInfoFiller
when ``uneven_depth`` is set, common/stages/genomic_info_filler.cpp:31-45):
instead of fitting the k-mer-spectrum mixture model, which assumes one
genomic coverage peak, scan the coverage histogram of short
"interesting" edges (potential erroneous connections between branching
vertices) with a triangular sliding bucket and return the first coverage
where the histogram rises on at least half the bucket. The stage uses
``min(avg_edge_coverage, threshold)``.

Host NumPy over one copy of the edge table, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..graph.graph import Graph, edge_mask


def _host(g: Graph):
    """(alive, start_v, end_v, length in k-mers, cov float64) on the
    host."""
    return (edge_mask(g).cpu().numpy(), g.start_v.cpu().numpy(),
            g.end_v.cpu().numpy(), g.seq_len.cpu().numpy() - g.k,
            g.cov.cpu().numpy().astype(np.float64))


def interesting_edges(g: Graph) -> np.ndarray:
    """Edge ids of potential erroneous connections
    (ec_threshold_finder.hpp:33-48 ``IsInteresting``): short edges
    (length <= k+1 in k-mers) between a branching start and a branching
    end, excluding plain parallel-edge bulge pairs."""
    alive, start_v, end_v, lens, _ = _host(g)
    v_space = int(max(start_v.max(initial=0), end_v.max(initial=0))) + 1
    out_deg = np.bincount(start_v[alive], minlength=v_space)
    in_deg = np.bincount(end_v[alive], minlength=v_space)

    cand = alive & (lens <= g.k + 1) & (out_deg[start_v] >= 2) \
        & (in_deg[end_v] >= 2)
    ids = np.nonzero(cand)[0]
    if ids.size == 0:
        return ids
    # exclude the pure 2-edge parallel bulge: the two out-edges of the
    # start are exactly the two in-edges of the end
    keep = np.ones(ids.size, bool)
    by_start: dict[int, list[int]] = {}
    by_end: dict[int, list[int]] = {}
    for e in np.nonzero(alive)[0]:
        by_start.setdefault(int(start_v[e]), []).append(int(e))
        by_end.setdefault(int(end_v[e]), []).append(int(e))
    for i, e in enumerate(ids):
        outs = by_start.get(int(start_v[e]), [])
        ins = by_end.get(int(end_v[e]), [])
        if len(outs) == 2 and len(ins) == 2 and set(outs) == set(ins):
            keep[i] = False
    return ids[keep]


def avg_coverage(g: Graph) -> float:
    """Length-weighted mean edge coverage
    (ec_threshold_finder.hpp:88-97 ``AvgCoverage``)."""
    alive, _, _, lens, cov = _host(g)
    lens = lens.astype(np.float64)
    total = float((lens * alive).sum())
    if total <= 0:
        return 0.0
    return float((cov * lens * alive).sum() / total)


def find_threshold(g: Graph) -> float:
    """The sliding triangular-bucket scan
    (ec_threshold_finder.hpp:50-56 ``weight`` + :112-136
    ``FindThreshold``). Returns the coverage threshold, falling back to
    0.1*avg when no rise-dominated window exists."""
    avg = avg_coverage(g)
    ids = interesting_edges(g)
    if ids.size == 0:
        return 0.1 * avg
    cov = _host(g)[4][ids]
    hist = np.bincount(cov.astype(np.int64))
    bw = int(0.3 * avg + 5)
    size = hist.shape[0]

    padded = np.zeros(size + bw + 1, np.float64)
    padded[:size] = hist
    # weight(v) = sum_{i<bw} hist[v+i] * min(i+1, bw-i)
    tri = np.minimum(np.arange(1, bw + 1), bw - np.arange(bw)).astype(
        np.float64)
    w = np.array([float(padded[v:v + bw] @ tri) for v in range(size)])
    rise = np.zeros(size, bool)
    rise[1:] = w[1:] > w[:-1]

    cnt = 0
    for i in range(1, size - bw):
        if rise[i]:
            cnt += 1
        if i > bw and rise[i - bw]:
            cnt -= 1
        if 2 * cnt >= bw:
            return float(i)
    return 0.1 * avg


def uneven_ec_bound(g: Graph) -> float:
    """What GenomicInfoFiller stores for uneven-depth runs
    (genomic_info_filler.cpp:38-44): min(avg coverage, threshold)."""
    return min(avg_coverage(g), find_threshold(g))
