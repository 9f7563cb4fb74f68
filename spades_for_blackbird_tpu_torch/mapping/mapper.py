"""Batch read-to-graph mapping.

PyTorch counterpart of the JAX package's ``mapping/mapper.py``
(the reference's ``BasicSequenceMapper``/``SequenceMapperNotifier``,
modules/alignment/sequence_mapper.hpp:288,
sequence_mapper_notifier.hpp:25-100): every read k-mer is looked up in
the edge k-mer index, giving per-k-mer (oriented edge, implied read-start
offset) votes; a per-read reduction picks the winning alignment.

Conventions:
- oriented edge id = 2*edge + (0 if the read aligns to the edge's stored
  orientation else 1);
- ``start``: offset of read base 0 in the oriented edge's coordinates
  (may be negative if the read hangs off the edge start).

The read k-mers come from the extraction kernel's strand entry
(``counter.lookup_windows``). The JAX package sorts the votes by three
uint32 words (read, oriented edge, start + 2^20) and ranks placements by
four; here each pair of words is fused into one int64 key with the same
order, and only the windows that found their k-mer (the groups that
pass ``min_votes``) enter the sort, so no scatter aims the rest at a
dropped slot. Every sort is stable where the JAX package's is.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kmers import counter
from ..ops import segments
from .index import EdgeKmerIndex

_START_BIAS = 1 << 20
_LOW32 = 0xFFFFFFFF


class ReadMapping(NamedTuple):
    """Per-read winning alignment (one (edge, start) per read)."""
    oriented_edge: torch.Tensor  # (R,) int64; 2*edge + rc-bit, -1 unmapped
    start: torch.Tensor          # (R,) int64 read-base-0 offset
    votes: torch.Tensor          # (R,) int64 supporting k-mer count
    mapped: torch.Tensor         # (R,) bool


class ChainMapping(NamedTuple):
    """Per-read edge CHAIN: up to C placements ordered along the read
    (the reference's ``MappingPath``, sequence_mapper.hpp:288). A read
    whose top placement ties another over the same read range (a read
    inside a repeat copy) is ambiguous and not mapped."""
    oriented_edge: torch.Tensor  # (R, C) int64; -1 past chain_len
    start: torch.Tensor          # (R, C) int64 read-base-0 offset
    votes: torch.Tensor          # (R, C) int64
    chain_len: torch.Tensor      # (R,) int64
    mapped: torch.Tensor         # (R,) bool (chain_len>0 and unambiguous)


def map_kmers(index: EdgeKmerIndex, codes: torch.Tensor,
              lengths: torch.Tensor, k: int):
    """Per-position mapping of every read k-mer.

    Returns (edge (R, P), offset (R, P), same (R, P): the read's k-mer
    has the edge's orientation, found (R, P)); edge and offset are 0
    where not found."""
    R, L = codes.shape
    P = L - k + 1
    if index.capacity == 0:
        z = torch.zeros((R, P), dtype=torch.int64, device=codes.device)
        return z, z, z.bool(), z.bool()
    found, row, read_fwd = counter.lookup_windows(
        index.hay(), index.num, codes, lengths, k)
    return (index.edge[row], index.offset[row],
            read_fwd == index.is_fwd[row], found)


def _votes(index: EdgeKmerIndex, seq_len: torch.Tensor, codes, lengths,
           k: int):
    """The found windows' votes, grouped: sorted by (read, oriented edge,
    start) and run-length encoded. Returns (read, oe, start, votes,
    min_p, max_p) of every group (each (G,) int64), in that order."""
    edge, off, same, found = map_kmers(index, codes, lengths, k)
    R, P = found.shape
    at = torch.nonzero(found.reshape(-1)).flatten()   # row-major: read order
    read, pos = at // P, at % P
    edge, off, same = (edge.reshape(-1)[at], off.reshape(-1)[at],
                       same.reshape(-1)[at])
    start = torch.where(same, off - pos, seq_len[edge] - index.k - off - pos)
    oe = 2 * edge + (~same).to(torch.int64)
    hi = (read << 32) | oe
    lo = start + _START_BIAS
    perm = segments.lexsort_perm([hi, lo])
    hi, lo, pos = hi[perm], lo[perm], pos[perm]
    n = hi.shape[0]
    first = torch.nonzero(segments.run_heads([hi, lo])).flatten()
    last = torch.cat([first[1:] - 1, first.new_full((min(n, 1),), n - 1)])
    # a stable sort keeps a group's windows in read order: its first and
    # last rows hold its smallest and largest window position
    return (hi[first] >> 32, hi[first] & _LOW32, lo[first] - _START_BIAS,
            last - first + 1, pos[first], pos[last])


def map_reads(index: EdgeKmerIndex, seq_len: torch.Tensor,
              codes: torch.Tensor, lengths: torch.Tensor,
              k: int) -> ReadMapping:
    """Winning (oriented edge, start) per read by k-mer majority vote.
    Runs where ``index`` lies; ``codes`` and ``lengths`` must be there."""
    R = codes.shape[0]
    dev = codes.device
    g_read, g_oe, g_start, g_votes, _, _ = _votes(index, seq_len, codes,
                                                  lengths, k)
    G = g_read.shape[0]
    best = torch.zeros(R, dtype=torch.int64, device=dev).scatter_reduce_(
        0, g_read, g_votes, "amax")
    is_best = g_votes == best[g_read]
    # ambiguity: two distinct placements tie for best (reads fully inside
    # a repeat copy) -- such reads must not feed paired info
    n_best = torch.zeros(R, dtype=torch.int64, device=dev).index_add_(
        0, g_read, is_best.to(torch.int64))
    # deterministic tie-break: the first (smallest key) best group wins
    first_best = torch.full((R,), G, dtype=torch.int64,
                            device=dev).scatter_reduce_(
        0, g_read[is_best], torch.nonzero(is_best).flatten(), "amin")
    got = first_best < G
    fb = torch.clamp(first_best, max=max(G - 1, 0))
    if G == 0:
        g_oe = g_start = torch.zeros(1, dtype=torch.int64, device=dev)
    votes = torch.where(got, best, 0)
    return ReadMapping(
        oriented_edge=torch.where(got, g_oe[fb], -1),
        start=torch.where(got, g_start[fb], 0),
        votes=votes,
        mapped=got & (votes > 0) & (n_best <= 1))


def map_reads_multi(index: EdgeKmerIndex, seq_len: torch.Tensor,
                    codes: torch.Tensor, lengths: torch.Tensor, k: int,
                    max_placements: int = 4,
                    min_votes: int = 2) -> ChainMapping:
    """Chain mapping: group per-k-mer votes into placements, order them
    along the read, greedily keep non-overlapping ones. Groups below
    ``min_votes`` supporting k-mers are noise (single shared k-mers near
    junctions) and are dropped."""
    C = max_placements
    S = 2 * max_placements  # candidate slots per read before the greedy
    R = codes.shape[0]
    dev = codes.device
    g_read, g_oe, g_start, g_votes, g_minp, g_maxp = _votes(
        index, seq_len, codes, lengths, k)
    keep = g_votes >= min_votes
    g_read, g_oe, g_start, g_votes, g_minp, g_maxp = (
        x[keep] for x in (g_read, g_oe, g_start, g_votes, g_minp, g_maxp))
    # rank a read's groups by votes (desc), then min_p, then oriented edge;
    # ties keep the group order (by start), as the JAX package's stable sort
    perm = segments.lexsort_perm([
        (g_read << 32) | ((1 << 30) - g_votes), (g_minp << 32) | g_oe])
    g_read, g_oe, g_start, g_votes, g_minp, g_maxp = (
        x[perm] for x in (g_read, g_oe, g_start, g_votes, g_minp, g_maxp))
    slot = (torch.arange(g_read.shape[0], device=dev)
            - torch.searchsorted(g_read, g_read))
    ok = slot < S
    dest = g_read[ok] * S + slot[ok]

    def slots(vals, fill):
        out = torch.full((R * S,), fill, dtype=torch.int64, device=dev)
        out[dest] = vals[ok]
        return out.view(R, S)

    s_oe = slots(g_oe, -1)
    s_start = slots(g_start, 0)
    s_votes = slots(g_votes, 0)
    s_minp = slots(g_minp, 1 << 30)
    s_maxp = slots(g_maxp, -1)

    # ambiguity: another slot ties the top votes while covering an
    # overlapping read range (repeat-interior alternatives)
    overlaps0 = (s_minp <= s_maxp[:, :1]) & (s_maxp >= s_minp[:, :1])
    tie = (s_votes == s_votes[:, :1]) & overlaps0 & (s_votes > 0)
    ambiguous = torch.any(tie[:, 1:], dim=1)

    # order candidate slots along the read, then greedy non-overlap
    order = torch.argsort(torch.where(s_votes > 0, s_minp, 1 << 30), dim=1,
                          stable=True)
    o_oe, o_start, o_votes, o_minp, o_maxp = (
        torch.gather(x, 1, order)
        for x in (s_oe, s_start, s_votes, s_minp, s_maxp))
    n_taken = torch.zeros(R, dtype=torch.int64, device=dev)
    last_max = torch.full((R,), -1, dtype=torch.int64, device=dev)
    taken = torch.zeros((R, S), dtype=torch.bool, device=dev)
    for i in range(S):
        take = ((o_votes[:, i] > 0) & (o_minp[:, i] > last_max)
                & (n_taken < C))
        taken[:, i] = take
        n_taken += take
        last_max = torch.where(take, o_maxp[:, i], last_max)

    # compact the accepted slots (at most C) to the first C columns
    dest = torch.where(taken, torch.cumsum(taken, 1) - 1, C)

    def chain(vals, fill):
        out = torch.full((R, C + 1), fill, dtype=torch.int64, device=dev)
        return out.scatter_(1, dest, torch.where(taken, vals, fill))[:, :C]

    return ChainMapping(
        oriented_edge=chain(o_oe, -1), start=chain(o_start, 0),
        votes=chain(o_votes, 0), chain_len=torch.clamp(n_taken, max=C),
        mapped=(n_taken > 0) & ~ambiguous)


def normalize_mapping(m, conj: torch.Tensor):
    """Rewrite rc-orientation hits (oid 2e+1) as forward hits on the
    conjugate edge (oid 2*conj[e]): the conjugate edge's sequence IS the
    reverse complement, so offsets carry over unchanged. After this, all
    oriented ids are even. Takes a ReadMapping or a ChainMapping."""
    oe = m.oriented_edge
    e = torch.div(oe, 2, rounding_mode="floor")
    rc = torch.remainder(oe, 2) == 1
    e2 = torch.where(rc, conj[torch.clamp(e, min=0)], e)
    return m._replace(oriented_edge=torch.where(oe >= 0, 2 * e2, -1))


normalize_chain = normalize_mapping
