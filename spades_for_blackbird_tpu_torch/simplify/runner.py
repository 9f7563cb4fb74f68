"""Simplification orchestration: iterative tips/bulges/EC to a fixed point.

PyTorch counterpart of ``spades_for_blackbird_tpu/simplify/runner.py``
(the reference's GraphSimplifier: InitialCleaning -> cycle of {tip,
bulge, EC} with iterative coverage thresholds -> PostSimplification),
with parameter semantics from configs/debruijn/simplification.info:

- tc_lb:   max_tip_length = round(min(k, read_len/2) * tc_lb)
- cb:      absolute coverage upper bound; None = detected coverage bound
- rctc:    tip_cov < rctc * max coverage of competing edges
- to_ec_lb: max_ec_length = 2 * tip_length(to_ec_lb) - 1
- icb:     iterative coverage bound, ramped linearly over the cycle
- bulge:   max_bulge_length = max(coeff * k, k + additive)

Of the post-simplification passes the port runs those the isolate
defaults enable: complex tips and path bulges. A configuration that
enables another one raises ``NotImplementedError``; ROADMAP.md queues
those passes.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..graph.graph import Graph, edge_mask
from ..utils.logger import get_logger
from ..utils.timetrace import scope as _scope
from . import advanced, passes
from .recondense import recondense

_log = get_logger("Simplification")


@dataclass
class SimplifyConfig:
    """Simplification parameters (isolate-mode defaults of the reference,
    configs/debruijn/simplification.info), as in the JAX package. The
    ``*_enabled`` switches of passes the port does not run yet stay, and
    raise NotImplementedError when set; their tuning fields come with
    the passes."""
    read_length: int = 100
    # tip clipper cycle clauses: (tc_lb, cb_absolute_or_None=auto, rctc)
    tip_clauses: tuple = ((1.5, 1.5, 2.0), (2.0, 1.5, None))
    # final tip clipper clauses
    final_tip_clauses: tuple = ((1.5, 3.0, 2.0), (4.0, None, None))
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
    # complex tip clipper (complex_tc block; enabled by default upstream)
    complex_tc_enabled: bool = True
    complex_tc_max_edge_len: int = 100
    complex_tc_lb: float = 3.5
    complex_tc_rel_coverage: float = -1.0
    # cycle (cycle_iter_count)
    rounds: int = 10
    # ier with use_rl_for_max_length_any_cov: isolated edges up to
    # read_length go regardless of coverage
    isolated_max_length: int | None = None
    isolated_max_coverage: float = 1e18
    # passes not ported yet: setting any of these raises
    low_complexity_enabled: bool = False
    rcc_enabled: bool = False
    red_enabled: bool = False
    superbubble_enabled: bool = False
    tec_enabled: bool = False
    mfec_enabled: bool = False
    her_enabled: bool = False
    her_meta: bool = False


# SimplifyConfig switches whose passes are not ported yet
_UNPORTED = (
    ("low_complexity_enabled", "rna low-complexity clippers"),
    ("rcc_enabled", "relative-coverage component remover (rcc)"),
    ("red_enabled", "relative-coverage edge disconnector (red)"),
    ("superbubble_enabled", "superbubble collapse"),
    ("tec_enabled", "topology EC removers (tec/trec/isec)"),
    ("mfec_enabled", "max-flow EC remover (mfec)"),
    ("her_enabled", "hidden EC remover (her)"),
    ("her_meta", "meta hidden EC remover (her)"),
)


def check_ported(cfg: SimplifyConfig) -> None:
    """Raise for configuration branches the port does not run yet."""
    for name, what in _UNPORTED:
        if getattr(cfg, name):
            raise NotImplementedError(
                f"SimplifyConfig.{name}: the {what} is not ported to "
                f"PyTorch yet (ROADMAP.md, Queue 1, 'Still to port')")
    for clause in tuple(cfg.tip_clauses) + tuple(cfg.final_tip_clauses):
        if len(clause) > 3:
            raise NotImplementedError(
                "tip clause with a mismatch-tip condition "
                "(advanced.mismatch_tip_mask) is not ported to PyTorch yet "
                "(ROADMAP.md, Queue 1, 'Still to port')")


def _tip_length(k: int, read_length: int, lb: float) -> int:
    # LengthThresholdFinder::MaxTipLength: round(min(k, read_length/2)
    # * coeff), compared against edge length in k-mers
    return int(round(min(k, read_length / 2) * lb))


def _clip_tips_clauses(g: Graph, v_space: int, clauses, k: int,
                       read_length: int, auto_cb: float) -> Graph:
    for lb, cb, rctc in clauses:
        g = passes.clip_tips(g, v_space, _tip_length(k, read_length, lb),
                             auto_cb if cb is None else cb,
                             1e18 if rctc is None else rctc)
    return g


def simplify_graph(g: Graph, v_space: int, ec_bound: float,
                   cfg: SimplifyConfig = SimplifyConfig()) -> Graph:
    """Run the simplification cycle. ``ec_bound`` is the detected
    coverage bound from the coverage model (GenomicInfo.ec_bound)."""
    check_ported(cfg)
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
                                     cfg.bulge_max_coverage)
            g = recondense(g, v_space)
            g = passes.remove_erroneous_connections(g, v_space, ec_len,
                                                    ec_thr)
            g = recondense(g, v_space)

    # post-simplification (PostSimplification order)
    if cfg.complex_tc_enabled:
        with _scope("complex_tips"):
            g, v_space, n = advanced.clip_complex_tips(
                g, v_space, max_edge_len=cfg.complex_tc_max_edge_len,
                max_path_len=_tip_length(k, rl, cfg.complex_tc_lb),
                relative_coverage=cfg.complex_tc_rel_coverage)
        if n:
            g = recondense(g, v_space)

    if cfg.path_bulge_enabled:
        with _scope("path_bulges"):
            g, v_space, n = advanced.remove_path_bulges(
                g, v_space, max_length=bulge_len,
                max_coverage=cfg.bulge_max_coverage,
                max_relative_coverage=cfg.bulge_max_rel_coverage,
                max_relative_delta=cfg.bulge_rel_delta,
                min_identity=cfg.bulge_min_identity)
        if n:
            g = recondense(g, v_space)

    # final tip clipper + bulge pass (final_br)
    g = _clip_tips_clauses(g, v_space, cfg.final_tip_clauses, k, rl, auto_cb)
    g = recondense(g, v_space)
    if cfg.final_br_enabled:
        g = passes.remove_bulges(g, v_space, bulge_len, cfg.bulge_rel_delta,
                                 cfg.bulge_max_coverage)
        g = recondense(g, v_space)

    iso_len = cfg.isolated_max_length
    if iso_len is None:
        iso_len = rl
    g = passes.remove_isolated(g, v_space, iso_len, cfg.isolated_max_coverage)
    if _log.enabled(1):  # DEBUG: SimplificationCleanup-style stats
        _log.debug(f"simplified: {alive_edge_count(g)} edges alive")
    return g


def alive_edge_count(g: Graph) -> int:
    return int(edge_mask(g).sum())
