"""RNA-mode machinery: strand-specific coverage.

PyTorch counterpart of the JAX package's ``models/rna.py`` (the
reference's rnaSPAdes strand-specific coverage maps,
modules/alignment/rna/ss_coverage.hpp + ss_coverage_filler.hpp, and the
SSEdgeSplit stage, common/stages/ss_edge_split.cpp, config
ss_coverage_splitter): per-edge forward/reverse read coverage from the
batch mapping, and splitting of edges whose transcription is effectively
single-stranded so antisense artifacts can be cleaned.

The edge index and the read mapping run on the card, or on request on
the CPU (on the card they launch the k-mer kernel's strand entry: one
launch for the index, one a chunk of reads); the bins are summed and the
split graph is built on the host, then put back on the graph's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.graph import Graph, edge_mask
from ..mapping import chunked
from ..mapping import index as eidx
from ..utils.device import resolve_device


def _mapping(g: Graph, codes, lengths, device):
    """The reads' winning placements on ``g``, WITHOUT conjugate
    normalisation (oriented id 2e is sense, 2e+1 antisense), as host
    arrays (oriented edge, start, mapped)."""
    device = resolve_device(device, g.seq_flat)
    g = g.to(device)
    k = g.k
    idx = eidx.build_edge_index(g, k + 1, device=device)
    m = chunked.map_reads_chunked(idx, g.seq_len, codes, lengths, k + 1,
                                  device=device)
    return (m.oriented_edge.cpu().numpy(), m.start.cpu().numpy(),
            m.mapped.cpu().numpy())


def strand_specific_coverage(g: Graph, codes, lengths, device=None
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Per-edge (forward, reverse) read counts for a strand-specific
    library. Reads are mapped WITHOUT conjugate normalisation: a hit on
    oriented id 2e is sense, 2e+1 antisense. ``device``: by default the
    card the graph lies on, else the first card; the CPU only on
    request."""
    oe, _, ok = _mapping(g, codes, lengths, device)
    E = g.capacity
    fwd = np.zeros(E, np.int64)
    rev = np.zeros(E, np.int64)
    np.add.at(fwd, oe[ok & (oe % 2 == 0)] // 2, 1)
    np.add.at(rev, oe[ok & (oe % 2 == 1)] // 2, 1)
    return fwd, rev


def dominant_strand_fraction(fwd: np.ndarray, rev: np.ndarray
                             ) -> np.ndarray:
    total = fwd + rev
    dom = np.maximum(fwd, rev)
    return np.where(total > 0, dom / np.maximum(total, 1), 0.0)


def antisense_artifact_edges(g: Graph, fwd, rev,
                             min_edge_len: int = 200,
                             min_coverage: int = 5,
                             margin: float = 0.05) -> np.ndarray:
    """Edges whose own reads are overwhelmingly one strand while their
    conjugate partner carries almost nothing: candidates for
    strand-specific cleanup (ss_coverage_splitter semantics: bin_size
    aggregation simplified to whole-edge totals)."""
    alive = edge_mask(g).cpu().numpy()
    lens = g.seq_len.cpu().numpy()
    total = fwd + rev
    frac = dominant_strand_fraction(fwd, rev)
    return alive & (lens >= min_edge_len) & (total >= min_coverage) & \
        (frac >= 1.0 - margin)


def binned_strand_coverage(g: Graph, codes, lengths, bin_size: int = 50,
                           ss_orientation: str = "fr", device=None
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Per-edge per-bin (forward, reverse) read coverage.

    Counterpart of ``SSBinCoverageFiller``/``SSCoverageSplitter``'s bin
    accumulation (modules/alignment/rna/ss_coverage_filler.hpp +
    ss_coverage_splitter config, stages/ss_edge_split.cpp:40-44): each
    mapped read adds +1 to every bin its alignment covers, on the strand
    it aligned to. ``ss_orientation`` 'rf' means the library reads are
    the reverse complement of the transcript, so strands swap.

    Returns (fwd, rev), each (E, B) with B = ceil(max_edge_len/bin_size).
    """
    oe, st, mapped = _mapping(g, codes, lengths, device)
    ok = mapped & (oe >= 0)
    rl = torch.as_tensor(lengths).cpu().numpy()

    lens = g.seq_len.cpu().numpy()
    E = g.capacity
    B = max(1, int(-(-int(lens.max(initial=1)) // bin_size)))
    fwd = np.zeros((E, B), np.int64)
    rev = np.zeros((E, B), np.int64)

    e = oe[ok] // 2
    anti = (oe[ok] % 2) == 1
    s = st[ok]
    r = rl[ok]
    # read span in the edge's stored coordinates
    lo = np.where(anti, lens[e] - s - r, s)
    hi = lo + r
    lo = np.clip(lo, 0, lens[e])
    hi = np.clip(hi, 0, lens[e])
    if ss_orientation == "rf":
        anti = ~anti
    b0 = lo // bin_size
    b1 = np.maximum(b0, (hi - 1) // bin_size)
    max_span = int((b1 - b0).max(initial=0)) + 1
    for j in range(max_span):
        bj = b0 + j
        sel = bj <= b1
        tgt = np.where(sel & ~anti, e, E)
        np.add.at(fwd, (np.minimum(tgt, E - 1),
                        np.minimum(bj, B - 1)), np.where(tgt < E, 1, 0))
        tgt = np.where(sel & anti, e, E)
        np.add.at(rev, (np.minimum(tgt, E - 1),
                        np.minimum(bj, B - 1)), np.where(tgt < E, 1, 0))
    return fwd, rev


def strand_flip_positions(fwd_bins: np.ndarray, rev_bins: np.ndarray,
                          edge_len: int, bin_size: int,
                          min_flanking_coverage: int = 2,
                          coverage_margin: float = 5.0) -> list[int]:
    """Base positions where the dominant strand flips.

    A flip at bin boundary b requires both flanks to carry >=
    ``min_flanking_coverage`` reads and each side to dominate by
    ``coverage_margin``x (ss_coverage_splitter's margin semantics)."""
    nb = max(1, -(-edge_len // bin_size))
    f = fwd_bins[:nb].astype(np.float64)
    r = rev_bins[:nb].astype(np.float64)
    # classify bins: +1 strongly forward, -1 strongly reverse, 0 mixed/weak
    strong = np.zeros(nb, np.int8)
    strong[(f >= coverage_margin * r) & (f >= min_flanking_coverage)] = 1
    strong[(r >= coverage_margin * f) & (r >= min_flanking_coverage)] = -1
    # a flip = adjacent strong bins of opposite sign (mixed transition
    # bins in between are tolerated); cut at the midpoint boundary
    cuts = []
    idx = np.nonzero(strong)[0]
    for a, b in zip(idx[:-1], idx[1:]):
        if strong[a] != strong[b]:
            cuts.append(int((a + b) // 2 + 1) * bin_size)
    return cuts


def _revcomp(seq: np.ndarray) -> np.ndarray:
    """Reverse complement of host codes (N stays N)."""
    return np.where(seq >= 4, seq, 3 - seq)[::-1].astype(np.uint8)


def split_edges_by_strand(g: Graph, codes, lengths, bin_size: int = 50,
                          min_edge_len: int = 200,
                          min_edge_coverage: int = 5,
                          coverage_margin: float = 5.0,
                          min_flanking_coverage: int = 2,
                          ss_orientation: str = "fr",
                          device=None) -> tuple[Graph, int, int]:
    """SSEdgeSplit stage body (common/stages/ss_edge_split.cpp:17-59 +
    SSCoverageSplitter::SplitEdges): split edges where the transcribed
    strand flips, so sense and antisense transcripts stop sharing one
    edge. Splitting edge e at base p yields pieces seq[:p+k] and
    seq[p:] joined at a fresh vertex (the reference's g.SplitEdge);
    conjugates mirror. The reads are mapped on ``device`` (by default the
    card the graph lies on, else the first card; the CPU only on
    request); the split graph is built on the host and put where ``g``
    lies. Returns (graph, n_edges_split, new_v_space)."""
    k = g.k
    lens = g.seq_len.cpu().numpy()
    alive = edge_mask(g).cpu().numpy()
    conj = g.conj.cpu().numpy()
    start_v = g.start_v.cpu().numpy()
    end_v = g.end_v.cpu().numpy()
    cov = g.cov.cpu().numpy()
    flat = g.seq_flat.cpu().numpy()
    starts = g.seq_start.cpu().numpy()

    fwd, rev = binned_strand_coverage(g, codes, lengths, bin_size,
                                      ss_orientation, device=device)

    # plan splits per conjugate pair
    plans: dict[int, list[int]] = {}
    for e in np.nonzero(alive)[0]:
        e = int(e)
        ce = int(conj[e])
        if ce < e or ce == e:
            continue
        if lens[e] < max(min_edge_len, 2 * k + 2):
            continue
        total = fwd[e] + rev[e] + fwd[ce] + rev[ce]
        if total.sum() < min_edge_coverage:
            continue
        # conjugate bins mirror onto this edge's coordinates
        nb = max(1, -(-int(lens[e]) // bin_size))
        cf = rev[ce][:nb][::-1]
        cr = fwd[ce][:nb][::-1]
        f = fwd[e][:nb] + cf
        r = rev[e][:nb] + cr
        cuts = strand_flip_positions(f, r, int(lens[e]), bin_size,
                                     min_flanking_coverage, coverage_margin)
        cuts = [p for p in cuts if k < p < lens[e] - k]
        if cuts:
            plans[e] = cuts
    if not plans:
        return g, 0, int(max(start_v.max(initial=0),
                             end_v.max(initial=0))) + 2

    next_v = (int(max(start_v.max(initial=0), end_v.max(initial=0))) + 2
              ) // 2 * 2 + 2

    # build the new edge list: (seq, cov, start_v, end_v), conj by pairing
    recs = []          # forward-piece records
    pair_of = []       # index of the conjugate record
    for e in np.nonzero(alive)[0]:
        e = int(e)
        ce = int(conj[e])
        if ce < e:
            continue
        seq = flat[starts[e]:starts[e] + lens[e]].copy()
        if e in plans and ce != e:
            cuts = [0] + plans[e] + [int(lens[e]) - k]
            n = len(cuts) - 1
            vs = [int(start_v[e])]
            for _ in range(n - 1):
                vs.append(next_v)
                next_v += 2
            vs.append(int(end_v[e]))
            base = len(recs)
            for i in range(n):
                piece = seq[cuts[i]:cuts[i + 1] + k]
                recs.append((piece, float(cov[e]), vs[i], vs[i + 1]))
                pair_of.append(base + n + (n - 1 - i))
            cseq = _revcomp(seq)
            clen = len(seq)
            ccuts = [clen - k - c for c in reversed(cuts)]
            cvs = [int(start_v[ce])] + [v ^ 1 for v in vs[1:-1][::-1]] + \
                [int(end_v[ce])]
            for i in range(n):
                piece = cseq[ccuts[i]:ccuts[i + 1] + k]
                recs.append((piece, float(cov[ce]), cvs[i], cvs[i + 1]))
                pair_of.append(base + (n - 1 - i))
        else:
            base = len(recs)
            recs.append((seq, float(cov[e]), int(start_v[e]),
                         int(end_v[e])))
            if ce == e:
                pair_of.append(base)
            else:
                cseq = flat[starts[ce]:starts[ce] + lens[ce]].copy()
                recs.append((cseq, float(cov[ce]), int(start_v[ce]),
                             int(end_v[ce])))
                pair_of.append(base + 1)
                pair_of.append(base)

    E2 = max(len(recs), 1)
    new_len = np.zeros(E2, np.int64)
    new_len[:len(recs)] = [len(s) for s, _, _, _ in recs]
    new_start = np.cumsum(new_len) - new_len
    new_flat = np.zeros(max(int(new_len.sum()), 1), np.uint8)
    for (s, _, _, _), at in zip(recs, new_start):
        new_flat[at:at + len(s)] = s
    cols = np.zeros((3, E2), np.int64)   # start_v, end_v, conj
    cols[:, :len(recs)] = [[sv for _, _, sv, _ in recs],
                           [ev for _, _, _, ev in recs], pair_of]
    new_cov = np.zeros(E2, np.float32)
    new_cov[:len(recs)] = [c for _, c, _, _ in recs]

    dev = g.device

    def put(a):
        return torch.from_numpy(a).to(dev)

    g2 = Graph(
        seq_flat=put(new_flat),
        seq_start=put(new_start),
        seq_len=put(new_len),
        cov=put(new_cov),
        start_v=put(cols[0]),
        end_v=put(cols[1]),
        conj=put(cols[2]),
        alive=torch.ones(E2, dtype=torch.bool, device=dev),
        num_edges=torch.tensor(len(recs), dtype=torch.int64, device=dev),
        k=k)
    return g2, len(plans), next_v
