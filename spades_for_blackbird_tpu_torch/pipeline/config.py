"""Layered assembly configuration with mode overlays.

PyTorch counterpart of the JAX package's ``pipeline/config.py``,
which replaces the reference's stacked ``.info`` property-tree config
(common/pipeline/config_struct.{hpp,cpp} ``load_cfg_from_files`` over
configs/debruijn/config.info + <mode>_mode.info + simplification.info;
pipeline mode enum at config_struct.hpp:38-50): a base dataclass plus
per-mode overlay functions mirroring the reference's mode files.

Modes (configs/debruijn/*_mode.info): isolate (base), meta, plasmid,
metaplasmid, rna, single-cell (sc) and the rest of ``MODES``. The port's
``SimplifyConfig`` holds the tuning fields of the passes it runs; an
overlay that sets a field of a pass not ported yet raises
``NotImplementedError`` naming the field (``_simplify``), so no mode drops
a setting silently. ``isolate`` and ``sc`` work fully.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace

from ..simplify.runner import SimplifyConfig
from ..path_extend.resolver import PEParams


MODES = ("isolate", "meta", "plasmid", "metaplasmid", "metaviral",
         "rna", "rnaviral", "corona", "sc", "bio", "moleculo",
         "large_genome")


@dataclass
class AssemblyConfig:
    mode: str = "isolate"
    ks: list[int] | None = None          # None = auto ladder
    careful: bool = False
    min_contig_length: int | None = None
    correction_enabled: bool = True      # hammer
    simplify: SimplifyConfig = field(default_factory=SimplifyConfig)
    pe: PEParams = field(default_factory=PEParams)
    # meta (meta_mode.info): two-step repeat resolution with intermediate
    # contigs re-fed as a trusted library
    two_step_rr: bool = False
    use_intermediate_contigs: bool = False
    # plasmid (plasmid_mode.info + projects/spades/chromosome_removal.cpp)
    chromosome_removal: bool = False
    circular_output: bool = False
    plasmid_min_edge_length: int = 1000
    plasmid_coverage_uniformity: float = 0.3
    # rna (rna_mode.info): strand-specific coverage machinery
    strand_specific: bool = False
    # bio (bgc_mode.info): HMM domain matching + restricted-edge masking
    domain_matching: bool = False
    # meta/MDA (config_struct uneven_depth): EC threshold from the
    # graph-based finder instead of the spectrum mixture fit
    # (genomic_info_filler.cpp:31-45)
    uneven_depth: bool = False
    # metaviral (metaviral_mode.info plasmid block): besides circular
    # candidates also emit linear dead-end-bounded candidates
    plasmid_output_linear: bool = False
    plasmid_min_circular_length: int = 1000
    plasmid_min_linear_length: int = 500
    # scaffolding mode (pe_params scaffolding_mode; large_genome uses
    # old_pe_2015 — 2015 scaffold-graph anchoring on unique edges only)
    scaffolding_mode: str = "old"


_SIMPLIFY_FIELDS = frozenset(f.name for f in fields(SimplifyConfig))


def _simplify(cfg: AssemblyConfig, **settings) -> SimplifyConfig:
    """``cfg.simplify`` with ``settings`` laid over it."""
    missing = sorted(set(settings) - _SIMPLIFY_FIELDS)
    if missing:
        raise NotImplementedError(
            f"SimplifyConfig.{missing[0]}: this mode tunes a simplification "
            f"pass that is not ported to PyTorch yet (also: "
            f"{', '.join(missing[1:]) or 'none'}; ROADMAP.md, Queue 1, "
            f"'Still to port')")
    return replace(cfg.simplify, **settings)


def _meta(cfg: AssemblyConfig) -> AssemblyConfig:
    # meta_mode.info: cycle_iter_count 3, ec "{ec_lb 30, icb 2.5}",
    # harsher tip clipping, two-step RR; rcc block (meta_mode.info:38-47:
    # gap 5, length_coeff 3, tips_coeff 5, vcnt 100, ec_len 300, no max
    # cov); red disconnector (:56-61 diff_mult 10, unconditional 50);
    # meta hidden-EC remover (simplification.cpp:319, relative 3)
    simp = _simplify(cfg, rounds=3, ec_icb=2.5, ec_lb_additive=30,
                     rcc_enabled=True, rcc_coverage_gap=5.0,
                     rcc_length_coeff=3.0, rcc_tip_allowing_coeff=5.0,
                     rcc_vertex_limit=100, rcc_max_ec_len_additive=300,
                     rcc_max_coverage_coeff=-1.0,
                     red_enabled=True, red_diff_mult=10.0,
                     red_unconditional_diff_mult=50.0,
                     her_meta=True, her_relative_threshold=3.0)
    return replace(cfg, mode="meta", two_step_rr=True,
                   use_intermediate_contigs=True, simplify=simp,
                   uneven_depth=True)


def _plasmid(cfg: AssemblyConfig) -> AssemblyConfig:
    return replace(cfg, mode="plasmid", chromosome_removal=True,
                   circular_output=True)


def _metaplasmid(cfg: AssemblyConfig) -> AssemblyConfig:
    cfg = _meta(cfg)
    return replace(cfg, mode="metaplasmid", chromosome_removal=True,
                   circular_output=True)


def _rna(cfg: AssemblyConfig) -> AssemblyConfig:
    # rna_mode.info: K ladder [33, 49] (options_storage.py K_MERS_RNA),
    # strand-specific coverage machinery + superbubble collapse;
    # tip condition "{ mmm 3 tc_lb 4, cb 100000, rctc 0.5 }
    # { tc_lb 2, cb 1, rctc 10000 }" (rna_mode.info:56) and the
    # low-complexity AT edge/tip clippers (rna_simplification.hpp)
    simp = _simplify(cfg, superbubble_enabled=True,
                     tip_clauses=((4.0, 100000.0, 0.5, 3.0),
                                  (2.0, 1.0, 10000.0)),
                     low_complexity_enabled=True)
    # uneven_depth covers mda/rna/meta/metaextrachromosomal/rnaviral
    # (config_struct.cpp:899-900)
    return replace(cfg, mode="rna", ks=cfg.ks or [33, 49],
                   strand_specific=True, simplify=simp,
                   uneven_depth=True)


def _sc(cfg: AssemblyConfig) -> AssemblyConfig:
    # careful single-cell (mda_mode.info): uneven coverage -> gentler EC
    # thresholds; rcc (mda_mode.info:39-48: gap 10, lengths 2/3, vcnt 30,
    # max_cov_coeff 5); hidden-EC remover (:57-63: unreliability 0.2,
    # relative 5)
    simp = _simplify(cfg, ec_icb=1.2,
                     rcc_enabled=True, rcc_coverage_gap=10.0,
                     rcc_length_coeff=2.0, rcc_tip_allowing_coeff=3.0,
                     rcc_vertex_limit=30, rcc_max_ec_len_additive=30,
                     rcc_max_coverage_coeff=5.0,
                     her_enabled=True, her_unreliability_coeff=0.2,
                     her_relative_threshold=5.0,
                     tec_enabled=True)
    return replace(cfg, mode="sc", simplify=simp, uneven_depth=True)


def _rnaviral(cfg: AssemblyConfig) -> AssemblyConfig:
    # rnaviral_mode.info: two_step_rr false; subspecies bulge remover
    # (:9-19: length_coeff 30, max_cov 1e6, max_relative_coverage 15,
    # max_relative_delta 0.2, min_identity 0.9) expressed through the
    # path-bulge pass; red disconnector (:21-27: diff_mult 10,
    # unconditional 50, edge_sum 0); final_br disabled (:29-32).
    # K ladder: rna values prefixed with 21
    # (spades_stage.py:117-127 generateK_for_rnaviral).
    simp = _simplify(cfg,
                     bulge_length_coeff=30.0,
                     bulge_max_coverage=1_000_000.0,
                     bulge_max_rel_coverage=15.0,
                     bulge_rel_delta=0.2,
                     bulge_min_identity=0.9,
                     final_br_enabled=False,
                     red_enabled=True, red_diff_mult=10.0,
                     red_unconditional_diff_mult=50.0,
                     red_edge_sum=0)
    return replace(cfg, mode="rnaviral", ks=cfg.ks or [21, 33, 49],
                   simplify=simp, uneven_depth=True)


def _corona(cfg: AssemblyConfig) -> AssemblyConfig:
    # coronaSPAdes = rnaviral pipeline + HMM domain-graph postprocessing
    # with the bundled coronavirus HMM set (options_parser.py:937
    # hmms_path = coronaspades_hmms; hmm_mode() true -> the bio-style
    # ExtractDomains/DomainGraphConstruction stages run). The HMM set
    # itself ships out-of-tree; the CLI takes it via --custom-hmms.
    cfg = _rnaviral(cfg)
    return replace(cfg, mode="corona", domain_matching=True)


def _metaviral(cfg: AssemblyConfig) -> AssemblyConfig:
    # metaviral_mode.info: metaextrachromosomal pipeline like
    # metaplasmid, but subspecies_br min_identity 0.7 and the plasmid
    # block's output_linear true / min_circular 1000 / min_linear 500 —
    # linear dead-end-bounded candidates are emitted too
    # (contig_output_stage.cpp:221-240 GetTipScaffolds)
    cfg = _meta(cfg)
    simp = _simplify(cfg,
                     bulge_length_coeff=30.0,
                     bulge_max_coverage=1_000_000.0,
                     bulge_max_rel_coverage=15.0,
                     bulge_rel_delta=0.2,
                     bulge_min_identity=0.7)
    return replace(cfg, mode="metaviral", chromosome_removal=True,
                   circular_output=True, simplify=simp,
                   plasmid_output_linear=True,
                   plasmid_min_circular_length=1000,
                   plasmid_min_linear_length=500)


def _moleculo(cfg: AssemblyConfig) -> AssemblyConfig:
    # moleculo_mode.info (truSPAdes barcode assembly): tc "{tc_lb 2.5,
    # cb 3, rctc 10000} {tc_lb 4.5, mmm 2}", br max_coverage 3, ec
    # "{ec_lb 30, icb 3.1}", rcc (gap 20, coeffs 2/3, vcnt 30, ec_len 30,
    # max_cov 5), her (1500, 0.2, 5), topology_simplif off
    simp = _simplify(cfg,
                     tip_clauses=((2.5, 3.0, 10000.0), (4.5, None, None, 2.0)),
                     bulge_max_coverage=3.0,
                     bulge_max_rel_coverage=100000.0,
                     ec_lb_additive=30, ec_icb=3.1,
                     rcc_enabled=True, rcc_coverage_gap=20.0,
                     rcc_length_coeff=2.0, rcc_tip_allowing_coeff=3.0,
                     rcc_vertex_limit=30, rcc_max_ec_len_additive=30,
                     rcc_max_coverage_coeff=5.0,
                     her_enabled=True, her_unreliability_coeff=0.2,
                     her_relative_threshold=5.0)
    return replace(cfg, mode="moleculo", simplify=simp)


def _large_genome(cfg: AssemblyConfig) -> AssemblyConfig:
    # large_genome_mode.info: only scaffolding_mode old_pe_2015
    return replace(cfg, mode="large_genome",
                   scaffolding_mode="old_pe_2015")


def _bio(cfg: AssemblyConfig) -> AssemblyConfig:
    # biosyntheticSPAdes (bgc_mode.info): two-step RR with domain
    # extraction on preliminary contigs and restricted-edge protection
    # in the second phase (pipeline.cpp:140-153)
    return replace(cfg, mode="bio", two_step_rr=True,
                   use_intermediate_contigs=True, domain_matching=True)


_OVERLAYS = {
    "isolate": lambda c: c,
    "meta": _meta,
    "plasmid": _plasmid,
    "metaplasmid": _metaplasmid,
    "metaviral": _metaviral,
    "rna": _rna,
    "rnaviral": _rnaviral,
    "corona": _corona,
    "sc": _sc,
    "bio": _bio,
    "moleculo": _moleculo,
    "large_genome": _large_genome,
}


def config_for_mode(mode: str = "isolate", **overrides) -> AssemblyConfig:
    if mode not in _OVERLAYS:
        raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
    cfg = _OVERLAYS[mode](AssemblyConfig())
    if overrides:
        cfg = replace(cfg, **overrides)
    return cfg
