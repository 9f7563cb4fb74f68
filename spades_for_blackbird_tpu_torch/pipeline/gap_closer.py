"""Gap closing: join dead-end edge pairs supported by read pairs.

PyTorch counterpart of the JAX package's ``pipeline/gap_closer.py``
(the reference's GapClosing stage, projects/spades/gap_closer.cpp
``GapCloserPairedIndexFiller``:25 + ``GapCloser``:170): mate pairs whose
ends map onto two different dead-end edges witness that the edges are
adjacent; the joint is made by aligning the tip ends for the best
overlap, tolerating up to ``hamming_bound`` mismatches
(gap_closer.cpp:396 LimitedHammingDistance, bound=2 at :472) with the
reference's low-complexity overlap rejection (:404-414), and, on an
imperfect match, correcting the lower-coverage tip to the higher-coverage
one before merging (HandlePositiveHammingDistanceCase, :327-355).

The paired evidence comes from the mapping on the graph's device; the
joins touch a handful of tips and run on the host, on one copy of the
graph (``graph/host.host_view``), and the rebuilt graph goes back to the
graph's device.

The key of a (dead end, dead start) pair is ``p1 * E + p2`` in int64.
The JAX package asks for int64 there too, but without JAX's x64 mode it
computes in int32, where the key wraps negative once p1 * E passes 2^31
and the pair is dropped (ROADMAP.md, Queue 3, item 2): at a capacity E
of 2^16 or more the two packages then differ, and the port joins what
the JAX package misses (tests/test_torch_paired.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.graph import Graph
from ..graph.host import host_view
from ..mapping import chunked
from ..mapping import index as eidx
from ..mapping import mapper
from ..ops import dna
from ..utils.device import resolve_device
from ..utils.timetrace import device_scope


def _revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return np.where(codes >= dna.INVALID_CODE, codes, 3 - codes)[::-1]


def _support_pairs(m1, m2, is_dead_end, is_dead_start, E: int) -> dict:
    """{(dead end, dead start): number of pairs} over the mate pairs
    mapped to two different edges of that kind, in ascending key order.
    Only the deduplicated pairs cross to the host."""
    p1 = torch.div(m1.oriented_edge, 2, rounding_mode="floor")
    p2 = torch.div(m2.oriented_edge, 2, rounding_mode="floor")
    ok = m1.mapped & m2.mapped & (p1 != p2)
    ok &= (is_dead_end[torch.clamp(p1, 0, E - 1)]
           & is_dead_start[torch.clamp(p2, 0, E - 1)])
    keys, counts = torch.unique(p1[ok] * E + p2[ok], return_counts=True)
    return {(int(kk) // E, int(kk) % E): int(cc)
            for kk, cc in zip(keys.cpu().numpy(), counts.cpu().numpy())}


def close_gaps(g: Graph, codes1, lengths1, codes2, lengths2,
               min_support: int = 3, min_overlap: int = 10,
               max_overlap_scan: int = 150,
               hamming_bound: int = 2, device=None) -> tuple[Graph, int]:
    """One gap-closing round. Returns (graph, n_joined). Runs on
    ``device`` (``resolve_device``: the card unless ``"cpu"`` is asked
    for); the graph and the reads are moved there."""
    device = resolve_device(device, g.seq_flat)
    g = g.to(device)
    k = g.k
    E = g.capacity
    h = host_view(g)
    alive = h.mask
    start_v, end_v, conj, lens = h.start_v, h.end_v, h.conj, h.seq_len

    # the JAX package sizes the degree tables 4E + 2, which the strand
    # split's graph (new vertices, no padding) can outgrow: it raises
    # there (ROADMAP.md, Queue 3); a larger table changes no degree
    v_space = max(4 * E + 2, int(max(start_v.max(initial=0),
                                     end_v.max(initial=0))) + 1)
    out_deg = np.zeros(v_space, np.int64)
    in_deg = np.zeros(v_space, np.int64)
    np.add.at(out_deg, start_v[alive], 1)
    np.add.at(in_deg, end_v[alive], 1)
    # forward tips: dead ends on the right; acceptors: dead starts
    is_dead_end = alive & (out_deg[end_v] == 0)
    is_dead_start = alive & (in_deg[start_v] == 0)
    if not is_dead_end.any() or not is_dead_start.any():
        return g, 0

    with device_scope("gc_build_index", device):
        idx = eidx.build_edge_index(g, k + 1, device=device)
    codes1 = torch.as_tensor(codes1).to(device)
    codes2 = torch.as_tensor(codes2).to(device)
    lengths1 = torch.as_tensor(lengths1).to(device)
    lengths2 = torch.as_tensor(lengths2).to(device)
    c2rc = dna.revcomp_reads(codes2, lengths2)
    with device_scope("gc_map_reads", device):
        m1 = chunked.map_reads_chunked(idx, g.seq_len, codes1, lengths1,
                                       k + 1, device=device)
        m2 = chunked.map_reads_chunked(idx, g.seq_len, c2rc, lengths2,
                                       k + 1, device=device)
        m1 = mapper.normalize_mapping(m1, g.conj)
        m2 = mapper.normalize_mapping(m2, g.conj)
    del idx, c2rc

    support = _support_pairs(
        m1, m2, torch.from_numpy(is_dead_end).to(device),
        torch.from_numpy(is_dead_start).to(device), E)

    flat = h.seq_flat
    starts = h.seq_start

    def seq_of(e):
        return flat[starts[e]:starts[e] + lens[e]]

    joins = []
    used = set()
    for (e1, e2), cnt in sorted(support.items(), key=lambda kv: -kv[1]):
        if cnt < min_support:
            continue
        if e1 in used or e2 in used or conj[e1] in used or conj[e2] in used:
            continue
        if e2 == int(conj[e1]):
            continue  # joining an edge to its own conjugate = hairpin
        s1, s2 = seq_of(e1), seq_of(e2)
        scan = min(max_overlap_scan, len(s1), len(s2))
        best_ov, best_mism = 0, None
        for ov in range(scan, min_overlap - 1, -1):
            tail, head = s1[-ov:], s2[:ov]
            mism = np.nonzero(tail != head)[0]
            if len(mism) > hamming_bound:
                continue
            # low-complexity rejection (gap_closer.cpp:404-414): at the
            # shortest overlap forbid near-homopolymer overlaps, relax
            # linearly toward 0.8 identity at the longest
            counts = np.bincount(tail, minlength=4)
            gap = max(k - ov, 1)
            denom = max(k - min_overlap - 1, 1)
            ratio = 0.8 + 0.2 * (gap - 1) / denom
            if counts.max() > ratio * ov:
                break  # reference returns false for the pair
            best_ov, best_mism = ov, mism
            break
        if best_ov == 0:
            continue
        joins.append((int(e1), int(e2), best_ov, best_mism))
        used.update({e1, e2, int(conj[e1]), int(conj[e2])})

    if not joins:
        return g, 0

    # apply joins on the host: rebuild arrays with merged sequences
    new_alive = alive.copy()
    seqs = {}
    covs = h.cov.copy()
    new_start_v = start_v.copy()
    new_end_v = end_v.copy()
    new_conj = conj.copy()
    for e1, e2, ov, mism in joins:
        s1, s2 = seq_of(e1), seq_of(e2)
        if mism is not None and len(mism) > 0 and covs[e2] > covs[e1]:
            # correct the lower-coverage tip (first edge) to the
            # higher-coverage one (gap_closer.cpp:332-340 CorrectLeft)
            s1 = s1.copy()
            s1[len(s1) - ov:] = s2[:ov]
        merged = np.concatenate([s1, s2[ov:]])
        seqs[e1] = merged
        # conjugate join mirrors: conj(e2) + conj(e1)
        ce1, ce2 = int(conj[e1]), int(conj[e2])
        seqs[ce1] = _revcomp_codes(merged)
        w1, w2 = max(lens[e1] - k, 1), max(lens[e2] - k, 1)
        covs[e1] = covs[ce1] = (covs[e1] * w1 + covs[e2] * w2) / (w1 + w2)
        new_end_v[e1] = end_v[e2]
        new_start_v[ce1] = start_v[ce2]
        new_conj[e1] = ce1
        new_conj[ce1] = e1
        new_alive[e2] = False
        new_alive[ce2] = False

    # repack the flat buffer (id order == position order invariant)
    new_lens = lens.copy()
    for e, s in seqs.items():
        new_lens[e] = len(s)
    new_lens[~new_alive] = 0
    new_starts = np.zeros(E, np.int64)
    acc = 0
    needed = int(new_lens[new_alive].sum())
    FLAT = flat.shape[0]
    if needed > FLAT:  # grow to the next power of two
        FLAT = 1 << max(needed - 1, 1).bit_length()
    new_flat = np.zeros(FLAT, np.uint8)
    for e in np.nonzero(new_alive)[0]:
        s = seqs.get(e, flat[starts[e]:starts[e] + lens[e]])
        new_starts[e] = acc
        new_flat[acc:acc + len(s)] = s
        acc += len(s)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    g2 = g._replace(
        seq_flat=put(new_flat), seq_start=put(new_starts),
        seq_len=put(new_lens), cov=put(covs), start_v=put(new_start_v),
        end_v=put(new_end_v), conj=put(new_conj), alive=put(new_alive))
    return g2, len(joins)
