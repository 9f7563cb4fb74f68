"""Batch simplification passes: tips, parallel bulges, erroneous
connections, relatively low-covered edges, isolated edges.

PyTorch counterpart of the JAX package's ``simplify/passes.py``.
Every pass computes a deletion mask over the edge table against one
graph snapshot; conjugate edges are always deleted together; chains
re-contract afterwards via recondense().

Thresholds arrive as Python numbers and are compared in the tensors'
own dtype (float32 coverage), as the JAX package compares against
``jnp.float32`` scalars.
"""

from __future__ import annotations

import torch

from ..graph.graph import Graph, edge_mask
from ..ops import segments
from ..ops.segments import drop_scatter


def _delete(g: Graph, kill: torch.Tensor) -> Graph:
    """Kill edges and their conjugates."""
    conj_kill = torch.zeros(g.capacity, dtype=torch.bool, device=g.device)
    conj_kill[g.conj[kill]] = True
    return g._replace(alive=g.alive & ~(kill | conj_kill))


def _vertex_tables(g: Graph, v_space: int):
    m = edge_mask(g)
    one = m.to(torch.int64)
    vs = torch.where(m, g.start_v, v_space)
    ve = torch.where(m, g.end_v, v_space)
    out_deg = drop_scatter(v_space, vs, one)
    in_deg = drop_scatter(v_space, ve, one)
    return m, out_deg, in_deg


def _seg_max_excl_self(cov: torch.Tensor, seg: torch.Tensor,
                       contributing: torch.Tensor, v_space: int
                       ) -> torch.Tensor:
    """Per-edge max of ``cov`` over its segment EXCLUDING the edge itself
    (the reference's MaxCompetitorCoverage exclusion): segment max,
    segment runner-up and a count of max-attaining edges decide each
    edge's exclusive max."""
    segs = torch.where(contributing, seg, v_space)
    vmax = drop_scatter(v_space, segs, cov, "amax", init=-1.0)
    seg_c = torch.clamp(seg, max=v_space - 1)
    at_max = contributing & (cov >= vmax[seg_c])
    cnt = drop_scatter(v_space, torch.where(at_max, seg, v_space),
                       torch.ones_like(seg))
    vmax2 = drop_scatter(v_space,
                         torch.where(contributing & ~at_max, seg, v_space),
                         cov, "amax", init=0.0)
    alone_at_max = at_max & (cnt[seg_c] == 1)
    return torch.where(alone_at_max, vmax2[seg_c],
                       torch.clamp(vmax[seg_c], min=0.0))


def clip_tips(g: Graph, v_space: int, length_bound: int,
              coverage_bound: float, relative_coverage: float,
              require: torch.Tensor | None = None) -> Graph:
    """Remove short dead-end edges (TipCondition + RelativeCoverage
    TipCondition):

    - end vertex has in+out degree == 1, and out_deg(start) +
      in_deg(end) > 2 (an alternative exists);
    - length in k-mers <= length_bound; cov <= coverage_bound;
    - cov <= relative_coverage * (max competitor coverage + 1), where
      competitors are the OTHER out-edges of start and in-edges of end,
      loops excluded;
    - and, where ``require`` (an (E,) bool mask) is given, that mask (the
      rna mismatch-tip condition).
    """
    m, out_deg, in_deg = _vertex_tables(g, v_space)
    vss = torch.clamp(g.start_v, max=v_space - 1)
    ves = torch.clamp(g.end_v, max=v_space - 1)

    dead_end = (out_deg[ves] == 0) & (in_deg[ves] == 1)
    has_alt = (out_deg[vss] + in_deg[ves]) > 2
    contributing = m & (g.start_v != g.end_v)
    comp_out = _seg_max_excl_self(g.cov, g.start_v, contributing, v_space)
    comp_in = _seg_max_excl_self(g.cov, g.end_v, contributing, v_space)
    competitor = torch.maximum(comp_out, comp_in)
    kill = m & dead_end & has_alt & \
        (g.seq_len - g.k <= length_bound) & (g.cov <= coverage_bound) & \
        (g.cov <= relative_coverage * (competitor + 1.0))
    if require is not None:
        kill = kill & require
    return _delete(g, kill)


def remove_isolated(g: Graph, v_space: int, max_length: int,
                    max_coverage: float) -> Graph:
    """Drop isolated edges (both endpoints bare)."""
    m, out_deg, in_deg = _vertex_tables(g, v_space)
    vss = torch.clamp(g.start_v, max=v_space - 1)
    ves = torch.clamp(g.end_v, max=v_space - 1)
    isolated = (in_deg[vss] == 0) & (out_deg[vss] == 1) & \
        (out_deg[ves] == 0) & (in_deg[ves] == 1)
    kill = m & isolated & (g.seq_len - g.k <= max_length) & \
        (g.cov <= max_coverage)
    return _delete(g, kill)


def remove_bulges(g: Graph, v_space: int, max_length: int,
                  max_relative_delta: float, max_coverage: float,
                  protected: torch.Tensor | None = None) -> Graph:
    """Remove parallel simple bulges (AlternativesAnalyzer restricted to
    single-edge alternatives).

    Among alive edges sharing (start_v, end_v), keep the strongest by
    coverage, then the conjugate-invariant id min(e, conj(e)), and delete
    the rest when they are short (<= max_length), similar in length and
    below max_coverage. The removed coverage is projected onto the kept
    edge. ``protected`` edges ((E,) bool: the blackbird fork's restricted
    edge set, stages/simplification.cpp:200-212 bulge_callback) are never
    glued away.
    """
    E = g.capacity
    m = edge_mask(g)
    # group by (start_v, end_v) via a stable sort
    key = torch.stack([g.start_v, g.end_v], dim=1)
    skeys, (perm,), svalid = segments.sort_by_key_rows(
        key, (torch.arange(E, device=g.device),), m)
    same = segments.rows_equal_prev(skeys) & svalid
    gid = torch.cumsum(~same, 0) - 1  # group id per sorted row
    gid_c = torch.clamp(gid, max=E - 1)

    cov_p = g.cov[perm]
    len_p = g.seq_len[perm]
    cid_p = torch.minimum(perm, g.conj[perm])
    gid_safe = torch.where(svalid, gid, E)
    best_cov = drop_scatter(E, gid_safe,
                            torch.where(svalid, cov_p, -torch.inf),
                            "amax", init=-torch.inf)
    is_cand = svalid & (cov_p == best_cov[gid_c])
    best_cid = drop_scatter(E, torch.where(is_cand, gid, E), cid_p, "amin",
                            init=E)
    is_best = is_cand & (cid_p == best_cid[gid_c])
    best_len = drop_scatter(E, torch.where(is_best, gid, E), len_p, "amax")
    best_edge = drop_scatter(E, torch.where(is_best, gid, E), perm, "amax")

    blen = best_len[gid_c]
    # delta = max(max_delta=3, rel_delta * len), lengths in k-mers
    delta = torch.clamp(max_relative_delta * (len_p - g.k).to(torch.float32),
                        min=3.0)
    kill_p = svalid & ~is_best & \
        (len_p - g.k <= max_length) & (cov_p <= max_coverage) & \
        ((len_p - blen).abs().to(torch.float32) <= delta)

    if protected is not None:
        kill_p &= ~protected[perm]

    # scatter kill + coverage projection back to edge order
    kill = torch.zeros(E + 1, dtype=torch.bool, device=g.device)
    kill[torch.where(kill_p, perm, E)] = True
    add_cov = drop_scatter(E, torch.where(kill_p, best_edge[gid_c], E), cov_p)
    g = g._replace(cov=g.cov + add_cov)
    return _delete(g, kill[:E])


def remove_relative_low_coverage(g: Graph, v_space: int,
                                 coverage_gap: float,
                                 max_length: int) -> Graph:
    """Relative-coverage erroneous connection removal
    (relative_coverage_remover.hpp, the edge-level pre-pass of the rcc
    block): short edges (``seq_len <= max_length``, in bases as in the
    JAX package) whose coverage is ``coverage_gap`` times below the
    strongest flanking edges on BOTH sides are dropped. The strongest
    alternative at the start junction is the best edge into start_v or
    another edge out of it (the candidate does not compete with itself);
    the end junction is symmetric."""
    m = edge_mask(g)
    vs = torch.where(m, g.start_v, v_space)
    ve = torch.where(m, g.end_v, v_space)
    cov0 = torch.where(m, g.cov, 0.0)
    out_maxcov = drop_scatter(v_space, vs, cov0, "amax")
    in_maxcov = drop_scatter(v_space, ve, cov0, "amax")
    vss = torch.clamp(g.start_v, max=v_space - 1)
    ves = torch.clamp(g.end_v, max=v_space - 1)
    out_excl = _seg_max_excl_self(g.cov, g.start_v, m, v_space)
    in_excl = _seg_max_excl_self(g.cov, g.end_v, m, v_space)
    start_flank = torch.maximum(in_maxcov[vss], out_excl)
    end_flank = torch.maximum(out_maxcov[ves], in_excl)
    kill = m & (g.seq_len <= max_length) & \
        (g.cov * coverage_gap < start_flank) & \
        (g.cov * coverage_gap < end_flank)
    return _delete(g, kill)


def remove_erroneous_connections(g: Graph, v_space: int, max_length: int,
                                 coverage_threshold: float) -> Graph:
    """Remove short low-coverage edges whose removal keeps the graph flow
    intact (both junctions retain alternatives)."""
    m, out_deg, in_deg = _vertex_tables(g, v_space)
    vss = torch.clamp(g.start_v, max=v_space - 1)
    ves = torch.clamp(g.end_v, max=v_space - 1)
    keeps_flow = (out_deg[vss] > 1) & (in_deg[ves] > 1)
    kill = m & keeps_flow & (g.seq_len - g.k <= max_length) & \
        (g.cov < coverage_threshold)
    return _delete(g, kill)
