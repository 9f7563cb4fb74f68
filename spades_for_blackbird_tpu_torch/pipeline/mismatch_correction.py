"""Mismatch correction: majority-vote polishing of graph edge sequences.

PyTorch counterpart of the JAX package's ``pipeline/
mismatch_correction.py`` (the reference's MismatchCorrection stage,
projects/spades/mismatch_correction.cpp:98-420 ``MismatchShallNotPass``,
run under --careful): map every read onto the graph, count each read
base as a vote for its edge position, fold the votes across conjugate
edge pairs (a read voting base b at position p of edge e also witnesses
complement(b) at the mirrored position of conj(e)), and rewrite the
bases where a strict majority of the votes disagrees.

The JAX package scatters every vote into a (FLAT, 4) table and aims the
reads that miss the graph at one dropped slot; here only the kept votes
are selected and counted with one ``bincount`` over ``flat_pos * 4 +
base`` a chunk, so no atomic serialises on a dropped slot. Votes are
integers, hence the same on the card and on the CPU, and additive: a
read maps on its own, so the chunk size changes nothing.
"""

from __future__ import annotations

import torch

from ..graph.graph import Graph, edge_mask, slot_owner
from ..mapping import chunked, mapper
from ..mapping import index as eidx
from ..ops import dna
from ..utils.device import resolve_device
from ..utils.timetrace import device_scope as _scope


def _vote(g: Graph, m: mapper.ReadMapping, codes: torch.Tensor,
          lengths: torch.Tensor) -> torch.Tensor:
    """Votes (FLAT * 4,) of one chunk of reads, from their normalised
    mappings (every mapped read on its edge's forward strand)."""
    FLAT = g.seq_flat.shape[0]
    L = codes.shape[1]
    e = torch.clamp(torch.div(m.oriented_edge, 2, rounding_mode="floor"),
                    min=0)
    pos_in_read = torch.arange(L, device=codes.device)[None, :]
    epos = m.start[:, None] + pos_in_read                     # (R, L)
    ok = (m.mapped[:, None] & (pos_in_read < lengths[:, None])
          & (epos >= 0) & (epos < g.seq_len[e][:, None])
          & (codes < dna.INVALID_CODE))
    slot = (g.seq_start[e][:, None] + epos)[ok] * 4 + codes[ok]
    return torch.bincount(slot, minlength=4 * FLAT)


def _fix(g: Graph, votes: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The polished flat buffer and how many bases changed."""
    FLAT = g.seq_flat.shape[0]
    dev = g.device
    votes = votes.view(FLAT, 4)
    # conjugate fold: flat slot p of an edge mirrors to slot
    # seq_start[conj] + (len - 1 - pos_in_edge), bases complemented (the
    # codes 0..3 are A, C, G, T, so the complement reverses the columns)
    m = edge_mask(g)
    slot_edge = slot_owner(g.seq_start, m, FLAT)
    se = torch.clamp(slot_edge, min=0)
    pie = torch.arange(FLAT, device=dev) - g.seq_start[se]
    slot_ok = (slot_edge >= 0) & m[se] & (pie >= 0) & (pie < g.seq_len[se])
    conj_pos = g.seq_start[g.conj[se]] + (g.seq_len[se] - 1 - pie)
    conj_pos = torch.clamp(torch.where(slot_ok, conj_pos, 0), max=FLAT - 1)
    folded = votes + torch.where(slot_ok[:, None],
                                 votes[conj_pos].flip(1), 0)

    total = folded.sum(1)
    vmax, best = folded.max(1)
    # a fix needs a strict majority, so the order argmax breaks ties in
    # cannot change a result
    fix = slot_ok & (vmax * 2 > total) & (total > 0) \
        & (best.to(torch.uint8) != g.seq_flat)
    return (torch.where(fix, best.to(torch.uint8), g.seq_flat),
            int(fix.sum()))


def correct_mismatches(g: Graph, codes, lengths, chunk: int | None = None,
                       device=None) -> tuple[Graph, int]:
    """One round of read-consensus polishing. Returns (graph, n_fixed).

    Runs on ``device`` (``resolve_device``: by default the card the
    reads are on, else the first card; the CPU only on request). The
    edge index is built once; the reads are mapped and their votes
    counted in chunks of ``chunk`` reads (by default sized from the free
    memory, ``chunked.map_chunk_reads``), the reference's OpenMP vote
    buffers (mismatch_correction.cpp:188 CountStatistics) become a chunk
    loop."""
    device = resolve_device(device, codes)
    g = g.to(device)
    k = g.k
    codes = torch.as_tensor(codes).to(device=device, dtype=torch.uint8)
    lengths = torch.as_tensor(lengths).to(device=device, dtype=torch.int32)
    with _scope("mc_build_index", device):
        idx = eidx.build_edge_index(g, k + 1, device=device)
    if chunk is None:
        chunk = chunked.map_chunk_reads(codes.shape[1], k + 1, device)
    votes = torch.zeros(4 * g.seq_flat.shape[0], dtype=torch.int64,
                        device=device)
    with _scope("mc_map_vote", device):
        for lo in range(0, codes.shape[0], chunk):
            c, ln = codes[lo:lo + chunk], lengths[lo:lo + chunk]
            m = mapper.normalize_mapping(
                mapper.map_reads(idx, g.seq_len, c, ln, k + 1), g.conj)
            votes += _vote(g, m, c, ln)
    with _scope("mc_fix", device):
        new_flat, n = _fix(g, votes)
    if n == 0:
        return g, 0
    return g._replace(seq_flat=new_flat), n
