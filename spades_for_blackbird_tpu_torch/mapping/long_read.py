"""Long-read-to-graph alignment: seed -> diagonal-chain -> edge path.

PyTorch counterpart of the JAX package's ``mapping/long_read.py`` (the
reference's sensitive long-read aligner, modules/alignment/pacbio/
g_aligner.{hpp,cpp} ``GAligner::GetReadAlignment``, and the hybrid gap
closer, projects/spades/hybrid_aligning.cpp:143-330,
hybrid_gap_closer.hpp).

Seeding runs on the device: the edge index of the graph's seed_k-mers
(``index.build_edge_index``) and one lookup of every window of the reads
through the extraction kernel's strand entry (``mapper.map_kmers``), as
the read mapper does. The kernel takes rows of at most
``kmer_cuda.MAX_L`` bases, and long reads are longer: each read is cut
into rows that overlap by k - 1 bases, whose windows are consecutive
positions of the read, so every window is looked up once and each found
window is mapped back to its position in the read (the diagonal
``epos - p`` depends on it). Only the found windows come to the host.
Each read's chain depends on that read alone, so reads are taken in
chunks sized from the free memory; the chunk changes no result.

The per-read diagonal banding, the greedy chain, the bridge collection,
the cross-validation and the join rebuild are host NumPy and follow the
JAX package's algorithm step for step; the banding is written over all
hits of a chunk at once, in the JAX package's candidate order. Fills
are compared with the banded edit distance (``ops/align.py``, the hand
kernel ``csrc/banded_ed.cu`` on a card).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..graph.graph import Graph
from ..graph.host import host_view
from ..ops import align as align_ops
from ..ops import dna, kmer_cuda
from ..path_extend.polisher import _paths_between
from ..utils import membudget
from ..utils.device import resolve_device
from . import index as eidx
from . import mapper

# found windows a chunk holds on the CPU
CPU_CHUNK_WINDOWS = 1 << 22
# device bytes a window holds at the lookup's peak: the row codes and
# their gather index, the fused keys and strand byte, the search's rows
# and temporaries, edge, offset, orientation and the found windows'
# columns (as ``chunked.map_chunk_reads`` counts them)
_WINDOW_BYTES = 320


@dataclass
class ChainedHit:
    edge: int          # forward edge id (normalized orientation)
    read_lo: int       # first read position supporting the edge
    read_hi: int       # last read position (seed start) + seed_k
    edge_lo: int       # matching edge interval
    edge_hi: int
    votes: int


@dataclass
class LongReadAlignment:
    read_id: int
    chain: list[ChainedHit] = field(default_factory=list)

    @property
    def edge_path(self) -> list[int]:
        return [h.edge for h in self.chain]


def _seed_hits(idx, conj, seq_len, codes, lengths, k: int):
    """The found seed windows of a chunk of reads ((R, L) uint8 and (R,)
    int32 on the index's device): (read, position, forward edge, edge
    position) int64 NumPy arrays in (read, position) order."""
    dev = codes.device
    R, Lmax = codes.shape
    W = min(kmer_cuda.MAX_L, Lmax)
    empty = tuple(np.zeros(0, np.int64) for _ in range(4))
    if W < k or R == 0:
        return empty
    stride = W - k + 1
    lens = lengths.to(torch.int64)
    n_rows = torch.div(torch.clamp(lens - k + 1, min=0) + stride - 1,
                       stride, rounding_mode="floor")
    total = int(n_rows.sum())
    if total == 0:
        return empty
    row_read = torch.repeat_interleave(torch.arange(R, device=dev), n_rows,
                                       output_size=total)
    first = torch.cumsum(n_rows, 0) - n_rows
    row_start = (torch.arange(total, device=dev) - first[row_read]) * stride
    col = row_start[:, None] + torch.arange(W, device=dev)
    inside = col < lens[row_read][:, None]
    rows = codes.reshape(-1)[row_read[:, None] * Lmax
                             + torch.clamp(col, max=Lmax - 1)]
    rows = torch.where(inside, rows, dna.INVALID_CODE).to(torch.uint8)
    del col, inside
    row_len = torch.clamp(lens[row_read] - row_start, max=W).to(torch.int32)
    edge, off, same, found = mapper.map_kmers(idx, rows, row_len, k)
    del rows
    at = torch.nonzero(found.reshape(-1)).flatten()
    row, q = at // stride, at % stride
    edge = edge.reshape(-1)[at]
    off = off.reshape(-1)[at]
    same = same.reshape(-1)[at]
    # normalize: the read aligns forward onto fe
    fe = torch.where(same, edge, conj[edge])
    epos = torch.where(same, off, seq_len[fe] - k - off)
    return tuple(x.cpu().numpy() for x in (
        row_read[row], row_start[row] + q, fe, epos))


def _chain_chunk(read, pos, fe, epos, n_reads: int, seed_k: int,
                 min_votes: int, diag_slop: int) -> list[list[ChainedHit]]:
    """The JAX package's per-read banding and greedy chain over the seed
    hits of ``n_reads`` reads at once (arrays in (read, position)
    order): a chain a read."""
    chains: list[list[ChainedHit]] = [[] for _ in range(n_reads)]
    n = len(read)
    if n == 0:
        return chains
    diag = epos - pos
    # an edge's hits sorted by diagonal, cut into bands where two
    # neighbouring diagonals lie more than diag_slop apart
    order = np.lexsort((diag, fe, read))
    r_s, fe_s, d_s, p_s, e_s = (x[order] for x in (read, fe, diag, pos,
                                                    epos))
    new_group = np.ones(n, bool)
    new_group[1:] = (r_s[1:] != r_s[:-1]) | (fe_s[1:] != fe_s[:-1])
    new_band = new_group.copy()
    new_band[1:] |= (d_s[1:] - d_s[:-1]) > diag_slop
    band = np.cumsum(new_band) - 1
    group = np.cumsum(new_group) - 1
    b_lo = np.flatnonzero(new_band)
    cnt = np.diff(np.append(b_lo, n))
    # int(np.median(band)) of the band's sorted diagonals
    med = np.trunc((d_s[b_lo + (cnt - 1) // 2].astype(np.float64)
                    + d_s[b_lo + cnt // 2]) / 2.0)
    sel = np.abs(d_s - med[band]) <= diag_slop
    # the edge's first hit in the read orders its candidates
    group_first_p = np.minimum.reduceat(p_s, np.flatnonzero(new_group))
    sb, sp, se = band[sel], p_s[sel], e_s[sel]
    o2 = np.lexsort((sp, sb))
    sb, sp, se = sb[o2], sp[o2], se[o2]
    if len(sb) == 0:
        return chains
    head = np.ones(len(sb), bool)
    head[1:] = sb[1:] != sb[:-1]
    first = np.flatnonzero(head)
    last = np.append(first[1:] - 1, len(sb) - 1)
    votes = last - first + 1
    keep = votes >= min_votes
    first, last, votes, cb = first[keep], last[keep], votes[keep], \
        sb[first[keep]]
    c_read = r_s[b_lo[cb]]
    c_edge = fe_s[b_lo[cb]]
    c_first = group_first_p[group[b_lo[cb]]]
    read_lo, read_hi = sp[first], sp[last] + seed_k
    edge_lo, edge_hi = se[first], se[last] + seed_k
    # candidates by read coordinate, stronger first; ties keep the JAX
    # package's order (edges by first hit, an edge's bands by diagonal)
    o3 = np.lexsort((cb, c_first, -votes, read_lo, c_read))
    cols = [x[o3].tolist() for x in (c_read, c_edge, read_lo, read_hi,
                                      edge_lo, edge_hi, votes)]
    for r, e, rlo, rhi, elo, ehi, v in zip(*cols):
        chain = chains[r]
        if chain and rhi <= chain[-1].read_hi:
            continue  # contained in previous span
        if chain and rlo < chain[-1].read_hi - 3 * seed_k and \
                v < chain[-1].votes:
            continue  # heavy overlap with a stronger hit
        chain.append(ChainedHit(edge=e, read_lo=rlo, read_hi=rhi,
                                edge_lo=elo, edge_hi=ehi, votes=v))
    return chains


def _read_chunks(lengths: np.ndarray, k: int, device: torch.device):
    """[lo, hi) ranges of reads whose windows fit one lookup."""
    budget = membudget.reads_per_chunk(_WINDOW_BYTES, device,
                                       CPU_CHUNK_WINDOWS)
    windows = np.maximum(lengths.astype(np.int64), k)
    out, lo, acc = [], 0, 0
    for i, w in enumerate(windows):
        if acc and acc + w > budget:
            out.append((lo, i))
            lo, acc = i, 0
        acc += w
    if lo < len(windows):
        out.append((lo, len(windows)))
    return out


def align_long_reads(g: Graph, codes, lengths, seed_k: int = 13,
                     min_votes: int = 3, diag_slop: int = 40,
                     device=None) -> list[LongReadAlignment]:
    """Align a batch of long reads ((R, L) codes and (R,) lengths, NumPy
    or tensors) to the graph. Seeding runs on ``device``
    (``resolve_device``: by default the graph's card, else the first
    card; the CPU only on request)."""
    device = resolve_device(device, g.seq_flat)
    g = g.to(device)
    idx = eidx.build_edge_index(g, seed_k, device=device)
    codes = torch.as_tensor(codes).to(device=device, dtype=torch.uint8)
    lengths_t = torch.as_tensor(lengths).to(device=device,
                                            dtype=torch.int32)
    lengths_np = lengths_t.cpu().numpy()
    out: list[LongReadAlignment] = []
    for lo, hi in _read_chunks(lengths_np, seed_k, device):
        read, pos, fe, epos = _seed_hits(
            idx, g.conj, g.seq_len, codes[lo:hi].contiguous(),
            lengths_t[lo:hi], seed_k)
        chains = _chain_chunk(read, pos, fe, epos, hi - lo, seed_k,
                              min_votes, diag_slop)
        out.extend(LongReadAlignment(lo + r, chain)
                   for r, chain in enumerate(chains))
    return out


def _graph_path_fill(g, e1: int, e2: int, read_fill: np.ndarray,
                     band: int = 48, ed_frac: float = 0.3,
                     max_paths: int = 8, device=None) -> np.ndarray | None:
    """Bounded graph-path search between e1's end and e2's start whose
    spelled sequence edit-matches the long read's gap segment
    (gap_dijkstra.cpp DijkstraGapFiller). Enumerates candidate paths
    within a length window of the read segment, scores them with the
    banded edit distance on ``device`` (by default the graph's), and
    returns the best path's sequence when it clears the bound — else
    None (the caller falls back to read bases). ``g`` is a graph or its
    host view."""
    if device is None:
        device = g.device if isinstance(g, Graph) else "cpu"
    hv = host_view(g)
    alive = hv.mask
    start_v, end_v, seq_len = hv.start_v, hv.end_v, hv.seq_len
    starts, flat, k = hv.seq_start, hv.seq_flat, hv.k
    out_of: dict[int, list[int]] = {}
    for e in np.nonzero(alive)[0]:
        out_of.setdefault(int(start_v[e]), []).append(int(e))

    L = len(read_fill)
    cands = _paths_between(out_of, end_v, seq_len, k,
                           int(end_v[e1]), int(start_v[e2]),
                           max_len=L + max(band, int(0.2 * L)) + k,
                           max_paths=max_paths)
    # spell each candidate path's strict interior: every edge
    # contributes seq[k:] (dropping its shared start k-mer, already
    # spelled by the predecessor / by e1's tail), and the final k bases
    # duplicate e2's head k-mer and are dropped too
    seqs = []
    for path in cands:
        if not path:
            continue
        s = np.concatenate([flat[starts[m] + k: starts[m] + seq_len[m]]
                            for m in path])
        if len(s) < k:
            continue
        s = s[:len(s) - k]
        if abs(len(s) - L) <= max(band, int(0.2 * L)):
            seqs.append(s)
    if not seqs:
        return None
    B = len(seqs)
    M = max(max(len(s) for s in seqs), L, 1)
    ac = np.full((B, M), 4, np.uint8)
    bc = np.full((B, M), 4, np.uint8)
    al_ = np.zeros(B, np.int32)
    bl_ = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        ac[i, :len(s)] = s
        al_[i] = len(s)
        bc[i, :L] = read_fill
        bl_[i] = L
    d = _edit_distances(ac, al_, bc, bl_, band, device)
    best = int(np.argmin(d))
    if d[best] <= ed_frac * max(L, 1):
        return seqs[best]
    return None


def _edit_distances(ac, al_, bc, bl_, band: int, device) -> np.ndarray:
    """``banded_edit_distance`` of NumPy pairs, run on ``device``."""
    def put(x):
        return torch.from_numpy(x).to(device)
    return align_ops.banded_edit_distance(
        put(ac), put(al_), put(bc), put(bl_), band).cpu().numpy()


def hybrid_close_gaps(g: Graph, codes, lengths, seed_k: int = 13,
                      min_bridges: int = 2, band: int = 48,
                      max_fill: int = 2000, device=None
                      ) -> tuple[Graph, int]:
    """Join dead-end edge pairs bridged by long reads, filling the gap
    with the bridging read's sequence (the HybridLibrariesAligning stage
    + hybrid gap closer, projects/spades/hybrid_aligning.cpp:143-330 and
    hybrid_gap_closer.hpp). Fill sequences from multiple bridging reads
    are cross-validated with the banded edit distance. Runs on
    ``device`` (``resolve_device``: by default the graph's card); the
    graph comes back there."""
    device = resolve_device(device, g.seq_flat)
    g = g.to(device)
    alignments = align_long_reads(g, codes, lengths, seed_k=seed_k,
                                  device=device)
    codes_np = (codes.cpu().numpy() if isinstance(codes, torch.Tensor)
                else np.asarray(codes))
    hv = host_view(g)
    seq_len = hv.seq_len
    conj = hv.conj

    bridges: dict[tuple[int, int], list[np.ndarray]] = {}
    for al in alignments:
        for a, b in zip(al.chain, al.chain[1:]):
            # read segment between the matched intervals = gap fill;
            # clip to where the edges end/start
            tail_a = int(seq_len[a.edge]) - a.edge_hi  # unmatched edge tail
            head_b = b.edge_lo
            lo = a.read_hi + tail_a
            hi = b.read_lo - head_b
            if hi < lo - 3 * seed_k or hi - lo > max_fill:
                continue
            fill = codes_np[al.read_id][max(lo, 0):max(hi, 0)]
            bridges.setdefault((a.edge, b.edge), []).append(fill)

    flat = hv.seq_flat
    starts = hv.seq_start
    joins = []
    used: set[int] = set()
    for (e1, e2), fills in sorted(bridges.items(),
                                  key=lambda kv: -len(kv[1])):
        if len(fills) < min_bridges or e1 == e2 or e2 == int(conj[e1]):
            continue
        if e1 in used or e2 in used or int(conj[e1]) in used or \
                int(conj[e2]) in used:
            continue
        # cross-validate fills pairwise with banded edit distance
        ref = fills[0]
        agree = 1
        L = max(max(len(f) for f in fills), 1)
        if len(fills) > 1:
            B = len(fills) - 1
            ac = np.full((B, L), 4, np.uint8)
            bc = np.full((B, L), 4, np.uint8)
            al_ = np.zeros(B, np.int32)
            bl_ = np.zeros(B, np.int32)
            for i, f in enumerate(fills[1:]):
                ac[i, :len(ref)] = ref
                al_[i] = len(ref)
                bc[i, :len(f)] = f
                bl_[i] = len(f)
            d = _edit_distances(ac, al_, bc, bl_, band, device)
            agree += int(np.sum(d <= 0.35 * np.maximum(len(ref), bl_)))
        if agree < min_bridges:
            continue
        # graph-path gap search (the GAligner's gap Dijkstra,
        # modules/alignment/pacbio/gap_dijkstra.cpp): if a graph path
        # between the edges spells (within an edit-distance bound) the
        # read's gap segment, fill with the GRAPH sequence — assembled
        # bases instead of the error-prone long-read bases
        path_fill = _graph_path_fill(hv, e1, e2, ref, band=band,
                                     device=device)
        joins.append((e1, e2, ref if path_fill is None else path_fill))
        used.update({e1, e2, int(conj[e1]), int(conj[e2])})

    if not joins:
        return g, 0

    # apply joins (the same host-side rebuild as the JAX package's)
    E = g.capacity
    alive = hv.mask.copy()
    covs = hv.cov.copy()
    start_v = hv.start_v.copy()
    end_v = hv.end_v.copy()
    lens = seq_len.copy()
    seqs = {}

    def seq_of(e):
        return flat[starts[e]:starts[e] + lens[e]]

    for e1, e2, fill in joins:
        merged = np.concatenate([seq_of(e1), fill, seq_of(e2)])
        ce1, ce2 = int(conj[e1]), int(conj[e2])
        seqs[e1] = merged
        seqs[ce1] = dna.revcomp_codes(merged)
        w1, w2 = max(lens[e1] - g.k, 1), max(lens[e2] - g.k, 1)
        covs[e1] = covs[ce1] = (covs[e1] * w1 + covs[e2] * w2) / (w1 + w2)
        end_v[e1] = end_v[e2]
        start_v[ce1] = start_v[ce2]
        alive[e2] = alive[ce2] = False

    new_lens = lens.copy()
    for e, s in seqs.items():
        new_lens[e] = len(s)
    new_lens[~alive] = 0
    FLAT = flat.shape[0]
    total = int(new_lens[alive].sum())
    new_flat = np.zeros(max(FLAT, total), np.uint8)
    new_starts = np.zeros(E, np.int64)
    acc = 0
    for e in np.nonzero(alive)[0]:
        s = seqs.get(e, flat[starts[e]:starts[e] + lens[e]])
        new_starts[e] = acc
        new_flat[acc:acc + len(s)] = s
        acc += len(s)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    g2 = g._replace(
        seq_flat=put(new_flat), seq_start=put(new_starts),
        seq_len=put(new_lens), cov=put(covs), start_v=put(start_v),
        end_v=put(end_v), conj=put(conj.copy()), alive=put(alive))
    return g2, len(joins)
