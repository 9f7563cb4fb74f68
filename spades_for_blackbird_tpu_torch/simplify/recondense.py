"""Re-condensation: merge chains of alive edges after deletions.

PyTorch counterpart of the JAX package's ``simplify/recondense.py``:
after simplification passes mask edges dead, every non-branching chain
of surviving edges re-contracts with the shared pointer-jumping routine
(graph/pointer_jump.py). Merged sequences overlap by k bases; coverage
merges (k+1)-mer-weighted.
"""

from __future__ import annotations

import torch

from ..graph import pointer_jump
from ..graph.graph import FLANKING_RANGE, Graph, edge_mask, slot_owner
from ..ops.segments import drop_scatter


def recondense(g: Graph, v_space: int) -> Graph:
    """Contract non-branching chains of alive edges into single edges.

    ``v_space`` must upper-bound oriented vertex ids. Capacities are
    preserved; the merged chain reuses its start edge's slot, followers
    become dead slots.
    """
    E = g.capacity
    FLAT = g.seq_flat.shape[0]
    NONE = E
    dev = g.device
    idx = torch.arange(E, device=dev)
    m = edge_mask(g)
    one = m.to(torch.int64)

    # vertex degrees + unique out-edge per vertex (over alive edges)
    vs = torch.where(m, g.start_v, v_space)
    ve = torch.where(m, g.end_v, v_space)
    out_deg = drop_scatter(v_space, vs, one)
    in_deg = drop_scatter(v_space, ve, one)
    out_edge = drop_scatter(v_space, vs, idx, "amin", init=NONE)

    vsafe = torch.clamp(g.end_v, max=v_space - 1)
    can_link = m & (out_deg[vsafe] == 1) & (in_deg[vsafe] == 1)
    succ = torch.where(can_link, out_edge[vsafe], NONE)
    succ = torch.where(succ == idx, NONE, succ)  # self-loop guard

    chains = pointer_jump.contract_chains(succ, g.conj, m)
    rep, off, is_start = chains.rep, chains.off, chains.is_start
    rep_safe = torch.where(m, rep, E)

    # per-edge base contribution: start contributes len, follower len - k
    contrib = torch.where(m, g.seq_len - g.k, 0)
    merged_len = drop_scatter(E, rep_safe, contrib) + \
        torch.where(is_start, g.k, 0)

    # coverage: weight = number of (k+1)-mers = len - k. The float32
    # sums are taken in another order than XLA's (and with atomics on the
    # card), so merged coverage may differ in the last bits.
    w = torch.where(m, (g.seq_len - g.k).to(torch.float32), 0.0)
    cov_num = drop_scatter(E, rep_safe, g.cov * w)
    cov_den = drop_scatter(E, rep_safe, w)
    new_cov = torch.where(cov_den > 0,
                          cov_num / torch.clamp(cov_den, min=1e-9), 0.0)

    chain_len = drop_scatter(E, rep_safe, off + 1, "amax")
    rep_c = torch.clamp(rep, max=E - 1)
    is_last = m & (off == chain_len[rep_c] - 1)
    last_edge = drop_scatter(E, torch.where(is_last, rep, E), idx, "amax")
    last_c = torch.clamp(last_edge, max=E - 1)
    new_end_v = g.end_v[last_c]
    # conjugate of merged(start..last) = the chain starting at conj(last)
    new_conj = g.conj[last_c]

    # exclusive prefix of contrib along chains = base offset of each
    # source edge within its merged sequence
    succ_broken = torch.where(
        is_start[torch.clamp(succ, max=E - 1)] & (succ < E), NONE, succ)
    bases_before = pointer_jump.chain_exclusive_sum(
        succ_broken, is_start, m, contrib)

    # flanking coverage merge: each source edge contributes its flank
    # average over the slice of the FLANKING_RANGE window it occupies
    if g.flank is not None:
        window = torch.minimum(torch.clamp(FLANKING_RANGE - bases_before,
                                           min=0), contrib)
        flank_raw = drop_scatter(E, rep_safe,
                                 g.flank * window.to(torch.float32))
        new_flank = flank_raw / torch.clamp(
            merged_len - g.k, 1, FLANKING_RANGE).to(torch.float32)
    else:
        new_flank = None

    # new tightly-packed flat layout (id order == position order invariant)
    survives = is_start
    new_len_if = torch.where(survives, merged_len, 0)
    new_seq_start = torch.where(
        survives, torch.cumsum(new_len_if, 0) - new_len_if, 0)

    # map every old flat slot -> owning edge
    slot_edge = slot_owner(g.seq_start, m, FLAT)
    se = torch.clamp(slot_edge, min=0)
    pos_in_edge = torch.arange(FLAT, device=dev) - g.seq_start[se]
    in_edge = (slot_edge >= 0) & (pos_in_edge >= 0) & \
        (pos_in_edge < g.seq_len[se]) & m[se]
    dst = new_seq_start[torch.clamp(rep_safe[se], max=E - 1)] + \
        bases_before[se] + pos_in_edge
    dst = torch.where(in_edge, dst, FLAT)
    new_flat = torch.zeros(FLAT + 1, dtype=torch.uint8, device=dev)
    new_flat[dst] = g.seq_flat
    new_flat = new_flat[:FLAT]

    return Graph(
        seq_flat=new_flat,
        seq_start=new_seq_start,
        seq_len=new_len_if,
        cov=torch.where(survives, new_cov, 0.0),
        start_v=torch.where(survives, g.start_v, 0),
        end_v=torch.where(survives, new_end_v, 0),
        conj=torch.where(survives, new_conj, 0),
        alive=survives,
        num_edges=g.num_edges,
        k=g.k,
        flank=(None if new_flank is None
               else torch.where(survives, new_flank, 0.0)),
    )
