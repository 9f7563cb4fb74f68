"""Simplification orchestration: iterative tips/bulges/EC to a fixed point.

PyTorch counterpart of the JAX package's ``simplify/runner.py``
(the reference's GraphSimplifier: InitialCleaning -> cycle of {tip,
bulge, EC} with iterative coverage thresholds -> PostSimplification),
with parameter semantics from configs/debruijn/simplification.info:

- tc_lb:   max_tip_length = round(min(k, read_len/2) * tc_lb)
- cb:      absolute coverage upper bound; None = detected coverage bound
- rctc:    tip_cov < rctc * max coverage of competing edges
- to_ec_lb: max_ec_length = 2 * tip_length(to_ec_lb) - 1
- icb:     iterative coverage bound, ramped linearly over the cycle
- bulge:   max_bulge_length = max(coeff * k, k + additive)

The post-simplification passes run in the reference's order: rna's
low-complexity clippers, relative-coverage components (rcc), the
relative-coverage edge disconnector (red), complex tips, path bulges,
superbubbles, the final tip and bulge passes, the MDA topology block
(tec, trec, isec, multiplicity counting), the max-flow EC remover (mfec,
which no mode enables) and the hidden-EC remover (her).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..graph.graph import Graph, edge_mask
from ..utils.logger import get_logger
from ..utils.timetrace import device_scope
from ..utils.timetrace import scope as _scope
from . import advanced, passes
from .recondense import recondense
from .superbubble import collapse_superbubbles

_log = get_logger("Simplification")


@dataclass
class SimplifyConfig:
    """Simplification parameters (isolate-mode defaults of the reference,
    configs/debruijn/simplification.info), as in the JAX package."""
    read_length: int = 100
    # tip clipper cycle clauses: (tc_lb, cb_absolute_or_None=auto, rctc),
    # or with a fourth value, rna's mismatch-tip bound (mmm)
    tip_clauses: tuple = ((1.5, 1.5, 2.0), (2.0, 1.5, None))
    # final tip clipper clauses
    final_tip_clauses: tuple = ((1.5, 3.0, 2.0), (4.0, None, None))
    # rna low-complexity clippers (rna_simplification.hpp: AT edges
    # early, AT tips in post-simplification)
    low_complexity_enabled: bool = False
    # bulge remover (br)
    bulge_length_coeff: float = 3.0
    bulge_len_additive: int = 100   # max_additive_length_coefficient
    bulge_max_coverage: float = 1000.0
    bulge_rel_delta: float = 0.1
    # erroneous connection remover (ec): { to_ec_lb 0.8, icb auto }
    ec_to_lb: float = 0.8
    ec_icb: float = 1.5  # multiplier on the detected bound (isolate mode)
    # when set, max_ec_length = k + ec_lb_additive instead of the
    # tip-originated formula (the "ec_lb N" condition form)
    ec_lb_additive: int | None = None
    # bulge remover extras (br block): alternative path must carry at
    # least cov(e)/max_relative_coverage; min_identity 0 = disabled
    bulge_max_rel_coverage: float = 1.1
    bulge_min_identity: float = 0.0
    path_bulge_enabled: bool = True
    # final_br clause
    final_br_enabled: bool = True
    # relative-coverage component removal (rcc block; meta/sc enable it;
    # lengths are read_length multiples, relative_coverage_remover.hpp
    # via graph_simplification.hpp:409-440)
    rcc_enabled: bool = False
    rcc_coverage_gap: float = 5.0
    rcc_length_coeff: float = 2.0
    rcc_tip_allowing_coeff: float = 3.0
    rcc_vertex_limit: int = 30
    rcc_max_ec_len_additive: int = 30     # max_ec_length_coefficient
    rcc_max_coverage_coeff: float = 2.0   # <0 = unlimited
    # relative-coverage edge disconnector (red block; meta, rnaviral)
    red_enabled: bool = False
    red_diff_mult: float = 20.0
    red_edge_sum: int = 10000
    red_unconditional_diff_mult: float = 0.0
    # complex tip clipper (complex_tc block; enabled by default upstream)
    complex_tc_enabled: bool = True
    complex_tc_max_edge_len: int = 100
    complex_tc_lb: float = 3.5
    complex_tc_rel_coverage: float = -1.0
    # topology-based EC remover (tec; MDA mode only —
    # topology_simplif_enabled, mda_mode.info:6)
    tec_enabled: bool = False
    tec_max_ec_len_additive: int = 20   # max_ec_length_coefficient
    tec_uniqueness_length: int = 1500
    tec_plausibility_length: int = 200
    # topology+reliability EC remover (trec block,
    # simplification.info:212-217; runs with the MDA topology block)
    trec_max_ec_len_additive: int = 100
    trec_uniqueness_length: int = 1500
    trec_unreliable_coverage: float = 2.5
    # interstrand EC / thorn remover (isec block,
    # simplification.info:220-225)
    isec_max_ec_len_additive: int = 100
    isec_uniqueness_length: int = 1500
    isec_span_distance: int = 15000
    # max-flow EC remover (mfec block, simplification.info:228-234;
    # disabled by default in every reference mode, opt-in)
    mfec_enabled: bool = False
    mfec_max_ec_len_additive: int = 30  # max_ec_length_coefficient
    mfec_uniqueness_length: int = 1500
    mfec_plausibility_length: int = 200
    # hidden-EC removers (her block; sc enables plain, meta the meta kind)
    her_enabled: bool = False
    her_meta: bool = False
    her_uniqueness_length: int = 1500
    her_unreliability_coeff: float = 4.0  # x detected ec bound
    her_relative_threshold: float = 5.0
    # superbubble collapse (rna; superbubble_finder.hpp:21)
    superbubble_enabled: bool = False
    superbubble_max_length: int = 1000
    # cycle (cycle_iter_count)
    rounds: int = 10
    # ier with use_rl_for_max_length_any_cov: isolated edges up to
    # read_length go regardless of coverage
    isolated_max_length: int | None = None
    isolated_max_coverage: float = 1e18


def _tip_length(k: int, read_length: int, lb: float) -> int:
    # LengthThresholdFinder::MaxTipLength: round(min(k, read_length/2)
    # * coeff), compared against edge length in k-mers
    return int(round(min(k, read_length / 2) * lb))


def _clip_tips_clauses(g: Graph, v_space: int, clauses, k: int,
                       read_length: int, auto_cb: float) -> Graph:
    for clause in clauses:
        # (lb, cb, rctc), or with rna's mismatch-tip conjunct (mmm)
        lb, cb, rctc = clause[:3]
        require = None
        if len(clause) > 3:
            require = torch.from_numpy(advanced.mismatch_tip_mask(
                g, v_space, clause[3])).to(g.device)
        g = passes.clip_tips(g, v_space, _tip_length(k, read_length, lb),
                             auto_cb if cb is None else cb,
                             1e18 if rctc is None else rctc,
                             require=require)
    return g


def simplify_graph(g: Graph, v_space: int, ec_bound: float,
                   cfg: SimplifyConfig = SimplifyConfig(),
                   protected_fn=None) -> Graph:
    """Run the simplification cycle. ``ec_bound`` is the detected
    coverage bound from the coverage model (GenomicInfo.ec_bound).

    ``protected_fn(g) -> (E,) bool tensor``: edges protected from bulge
    gluing (the blackbird fork's restricted edges,
    simplification.cpp:200-212); evaluated anew for every bulge pass,
    because recondensation renumbers edges."""
    k = g.k
    rl = cfg.read_length
    auto_cb = max(ec_bound, 1.0)
    # MaxBulgeLength = max(k*coeff, k + additive), in k-mers
    bulge_len = max(int(round(cfg.bulge_length_coeff * k)),
                    k + cfg.bulge_len_additive)
    if cfg.ec_lb_additive is not None:
        ec_len = k + cfg.ec_lb_additive
    else:
        ec_len = 2 * _tip_length(k, rl, cfg.ec_to_lb) - 1
    final_ec_threshold = cfg.ec_icb * auto_cb

    _log.debug(f"simplification cycle: {cfg.rounds} rounds, "
               f"ec_len {ec_len}, final ec threshold "
               f"{final_ec_threshold:.2f}, bulge_len {bulge_len}")
    with _scope("simplify_cycle", rounds=cfg.rounds):
        for i in range(cfg.rounds):
            # iterative threshold ramp (IterativeThresholdsRun)
            ec_thr = final_ec_threshold * (i + 1) / cfg.rounds
            g = _clip_tips_clauses(g, v_space, cfg.tip_clauses, k, rl,
                                   auto_cb)
            g = recondense(g, v_space)
            g = passes.remove_bulges(g, v_space, bulge_len,
                                     cfg.bulge_rel_delta,
                                     cfg.bulge_max_coverage,
                                     protected=_protected(protected_fn, g))
            g = recondense(g, v_space)
            g = passes.remove_erroneous_connections(g, v_space, ec_len,
                                                    ec_thr)
            g = recondense(g, v_space)

    # post-simplification (PostSimplification order,
    # stages/simplification.cpp:230-330)
    if cfg.low_complexity_enabled:
        # rna "AT edges" + "AT Tips" (simplification.cpp:113,302)
        with device_scope("low_complexity", g.device):
            g, v_space, n1 = advanced.remove_low_complexity_short_edges(
                g, v_space)
            g, v_space, n2 = advanced.clip_low_complexity_tips(g, v_space)
            if n1 or n2:
                g = recondense(g, v_space)

    if cfg.rcc_enabled:
        # edge-level relative EC pre-pass, then the component remover
        # (relative_coverage_remover.hpp:692)
        with device_scope("rcc", g.device):
            g = passes.remove_relative_low_coverage(
                g, v_space, cfg.rcc_coverage_gap,
                int(cfg.rcc_length_coeff * rl))
            g = recondense(g, v_space)
            max_cov = (cfg.rcc_max_coverage_coeff * auto_cb
                       if cfg.rcc_max_coverage_coeff >= 0 else float("inf"))
            g, v_space, n = advanced.remove_rcc_components(
                g, v_space,
                coverage_gap=cfg.rcc_coverage_gap,
                length_bound=int(cfg.rcc_length_coeff * rl),
                tip_allowing_length_bound=int(cfg.rcc_tip_allowing_coeff
                                              * rl),
                longest_connecting_path_bound=k + cfg.rcc_max_ec_len_additive,
                max_coverage=max_cov,
                vertex_count_limit=cfg.rcc_vertex_limit)
            if n:
                g = recondense(g, v_space)

    if cfg.red_enabled:
        with device_scope("red", g.device):
            g, v_space, n = advanced.disconnect_relative_low(
                g, v_space, diff_mult=cfg.red_diff_mult,
                edge_sum=cfg.red_edge_sum,
                unconditional_diff_mult=cfg.red_unconditional_diff_mult)
            if n:
                g = recondense(g, v_space)

    if cfg.complex_tc_enabled:
        with _scope("complex_tips"):
            g, v_space, n = advanced.clip_complex_tips(
                g, v_space, max_edge_len=cfg.complex_tc_max_edge_len,
                max_path_len=_tip_length(k, rl, cfg.complex_tc_lb),
                relative_coverage=cfg.complex_tc_rel_coverage)
        if n:
            g = recondense(g, v_space)

    if cfg.path_bulge_enabled:
        prot = _protected(protected_fn, g)
        with _scope("path_bulges"):
            g, v_space, n = advanced.remove_path_bulges(
                g, v_space, max_length=bulge_len,
                max_coverage=cfg.bulge_max_coverage,
                max_relative_coverage=cfg.bulge_max_rel_coverage,
                max_relative_delta=cfg.bulge_rel_delta,
                min_identity=cfg.bulge_min_identity,
                protected=None if prot is None else prot.cpu().numpy())
        if n:
            g = recondense(g, v_space)

    if cfg.superbubble_enabled:
        with device_scope("superbubble", g.device):
            g, nb = collapse_superbubbles(
                g, max_length=cfg.superbubble_max_length)
            if nb:
                g = recondense(g, v_space)

    # final tip clipper + bulge pass (final_br; rnaviral disables it)
    g = _clip_tips_clauses(g, v_space, cfg.final_tip_clauses, k, rl, auto_cb)
    g = recondense(g, v_space)
    if cfg.final_br_enabled:
        g = passes.remove_bulges(g, v_space, bulge_len, cfg.bulge_rel_delta,
                                 cfg.bulge_max_coverage,
                                 protected=_protected(protected_fn, g))
        g = recondense(g, v_space)

    if cfg.tec_enabled:
        # MDA topology simplification block, in the reference's order:
        # tec -> trec -> isec (thorns) -> multiplicity counting
        # (simplification.cpp:83-87). Each pass recondenses what it cut
        # and the block recondenses once more, as the JAX package does:
        # a second recondense may move a float32 coverage by an ulp.
        with device_scope("topology_block", g.device):
            for remover, kw in (
                    (advanced.remove_topology_ec, dict(
                        max_ec_length=k + cfg.tec_max_ec_len_additive,
                        uniqueness_length=cfg.tec_uniqueness_length,
                        plausibility_length=cfg.tec_plausibility_length)),
                    (advanced.remove_tr_ec, dict(
                        max_ec_length=k + cfg.trec_max_ec_len_additive,
                        uniqueness_length=cfg.trec_uniqueness_length,
                        unreliable_coverage=cfg.trec_unreliable_coverage)),
                    (advanced.remove_thorns, dict(
                        max_ec_length=k + cfg.isec_max_ec_len_additive,
                        uniqueness_length=cfg.isec_uniqueness_length,
                        span_distance=cfg.isec_span_distance)),
                    (advanced.remove_multiplicity_ec, dict(
                        max_ec_length=k + cfg.tec_max_ec_len_additive,
                        uniqueness_length=cfg.tec_uniqueness_length,
                        plausibility_length=cfg.tec_plausibility_length))):
                g, v_space, n = remover(g, v_space, **kw)
                if n:
                    g = recondense(g, v_space)

    if cfg.mfec_enabled:
        # MaxFlowRemoveErroneousEdges (simplification.cpp:87)
        with device_scope("max_flow_ec", g.device):
            g, v_space, n = advanced.remove_max_flow_ec(
                g, v_space, max_ec_length=k + cfg.mfec_max_ec_len_additive,
                uniqueness_length=cfg.mfec_uniqueness_length,
                plausibility_length=cfg.mfec_plausibility_length)

    if cfg.her_enabled or cfg.her_meta:
        with device_scope("hidden_ec", g.device):
            g, v_space, n = advanced.remove_hidden_ec(
                g, v_space,
                uniqueness_length=cfg.her_uniqueness_length,
                unreliability_threshold=cfg.her_unreliability_coeff
                * auto_cb,
                ec_threshold=auto_cb,
                relative_threshold=cfg.her_relative_threshold,
                meta=cfg.her_meta)
            if n:
                g = recondense(g, v_space)

    iso_len = cfg.isolated_max_length
    if iso_len is None:
        iso_len = rl
    g = passes.remove_isolated(g, v_space, iso_len, cfg.isolated_max_coverage)
    if _log.enabled(1):  # DEBUG: SimplificationCleanup-style stats
        _log.debug(f"simplified: {alive_edge_count(g)} edges alive")
    return g


def _protected(protected_fn, g: Graph):
    return None if protected_fn is None else protected_fn(g)


def alive_edge_count(g: Graph) -> int:
    return int(edge_mask(g).sum())
