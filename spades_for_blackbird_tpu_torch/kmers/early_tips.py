"""Pre-graph early tip clipping on the (k+1)-mer table.

PyTorch counterpart of the JAX package's ``kmers/early_tips.py``
(the reference's EarlyTipClipper construction phase). The whole
(k+1)-mer multiset contracts into unique-in/unique-out chains by pointer
jumping, then every chain is classified at once:

- a *branch* is a chain whose first (k+1)-mer hangs off a junction
  vertex (out-degree >= 2), grouped by the oriented junction id;
- a branch is a *tip* iff its terminal (k+1)-mer dead-ends within the
  length bound;
- per junction, tips strictly shorter than the longest branch are
  removed (non-tip branches count as infinite).
"""

from __future__ import annotations

import torch

from ..graph import condense, pointer_jump
from ..ops import dna, segments
from . import extension
from .counter import KmerTable


def _tip_kill_mask(kp1_table: KmerTable, vt: extension.VertexTable,
                   k: int, length_bound: int) -> torch.Tensor:
    """Per-row kill mask over the (k+1)-mer table."""
    E = kp1_table.capacity
    O = 2 * E
    NONE = O
    dev = kp1_table.kmers.device
    ar = torch.arange(O, device=dev)

    ori, ovalid = condense.oriented_instances(kp1_table, k)
    # successor link: the junction between an instance and its follower
    # must be 1-in/1-out (the same rule as graph condensation)
    succ, _, _, _, omask, imask = condense.successors(kp1_table, vt, k, ori,
                                                      ovalid)
    od = extension.popcount4(omask)
    idg = extension.popcount4(imask)
    prefix = dna.truncate_bases(ori, k + 1, k)
    del ori

    chains = pointer_jump.contract_chains(succ, ar ^ 1, ovalid)
    rep, off, is_start = chains.rep, chains.off, chains.is_start
    rep_safe = torch.where(ovalid, rep, O)

    # chain length + terminal classification (FindForward's stop node)
    chain_len = segments.drop_scatter(O, rep_safe, off + 1, "amax")
    is_last = ovalid & (succ == NONE)
    # dead-end terminal: no outgoing extension, unique incoming
    tip_end = is_last & (od == 0) & (idg == 1)
    chain_tip_end = torch.zeros(O + 1, dtype=torch.bool, device=dev)
    chain_tip_end[torch.where(tip_end, rep, O)] = True
    chain_tip_end = chain_tip_end[:O]

    # prefix junction vertex of each chain start
    cpre, pfwd = dna.canonicalize_kmers(prefix, k)
    pvidx = segments.searchsorted_rows(vt.kmers, cpre)
    p_out_deg = extension.popcount4(
        extension.oriented_out_mask(vt, pvidx, pfwd))
    ov_start = 2 * pvidx + (~pfwd).to(torch.int64)
    at_junction = is_start & (p_out_deg >= 2)

    rep_c = torch.clamp(rep, max=O - 1)
    clen = chain_len[rep_c]
    is_tip = chain_tip_end[rep_c] & (clen <= length_bound)

    # per-junction longest branch; non-tip branches count as infinite
    INF = 1 << 30
    branch_val = torch.where(is_tip, clen, INF)
    VSP = 2 * vt.capacity
    grp = torch.where(at_junction, torch.clamp(ov_start, max=VSP - 1), VSP)
    grp_max = torch.zeros(VSP + 1, dtype=torch.int64, device=dev)
    grp_max.scatter_reduce_(0, grp, branch_val, "amax", include_self=True)
    remove_branch = at_junction & is_tip & \
        (clen < grp_max[torch.clamp(grp, max=VSP)])

    # kill every member of a removed chain, at the kp1-row level
    chain_killed = torch.zeros(O + 1, dtype=torch.bool, device=dev)
    chain_killed[torch.where(remove_branch, rep, O)] = True
    o_kill = ovalid & chain_killed[:O][rep_c]
    return o_kill[0::2] | o_kill[1::2]


def clip_early_tips(kp1_table: KmerTable, vt: extension.VertexTable,
                    k: int, length_bound: int) -> tuple[KmerTable, int]:
    """Remove tip (k+1)-mers; returns (filtered table, rows removed).
    The caller must rebuild the vertex table from the filtered table."""
    kill = _tip_kill_mask(kp1_table, vt, k, max(length_bound, 1))
    real = torch.arange(kp1_table.capacity,
                        device=kill.device) < kp1_table.num
    n = int((kill & real).sum())
    if n == 0:
        return kp1_table, 0
    num, (kmers, counts) = segments.compact(
        ~kill & real, kp1_table.kmers, kp1_table.counts)
    pad = torch.arange(kp1_table.capacity, device=kill.device) >= num
    kmers = torch.where(pad[:, None], dna.WORD_MASK, kmers)
    return KmerTable(kmers, counts, num), n
