"""Single-K assembly, the K ladder and repeat resolution: reads ->
simplified graph -> contigs and scaffolds.

PyTorch counterpart of the JAX package's ``pipeline/assemble.py``,
single-device branch. ``assemble_single_k`` counts (k+1)-mers, fits the
coverage model, builds the vertex table, clips early tips, condenses
unitigs, compacts, simplifies and emits contigs (the reference's per-K
Construction -> GenomicInfoFiller -> Simplification -> ContigOutput).
``assemble_multi_k`` runs it once per K, each rung's contigs fed into the
next rung's construction. ``repeat_resolution_multi`` maps paired
libraries onto the final graph and extends, joins and scaffolds paths
through it (the reference's RepeatResolution).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import interop
from ..graph import condense, construct
from ..graph.graph import compact_graph
from ..graph.host import host_view
from ..io import fasta
from ..kmers import counter, coverage_model, early_tips, extension
from ..mapping import chunked, long_read, mapper
from ..mapping import index as eidx
from ..models import bio
from ..ops import dna
from ..paired import insert_size, pair_info
from ..path_extend import loop_traverser, polisher, resolver, scaffolder
from ..simplify import ec_threshold, runner
from ..utils import timetrace
from ..utils.device import resolve_device
from ..utils.logger import get_logger
from ..utils.timetrace import device_scope as _scope

_log = get_logger("Assembler")


@dataclass
class AssemblyResult:
    contigs: list[tuple[str, float]]
    genomic_info: coverage_model.GenomicInfo
    stats: dict
    graph: object = None  # final simplified Graph


def _to_device(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _windows_from_sequences(seqs: list[str], width: int, k: int):
    """Chop sequences into overlapping windows of ``width`` so every
    k-mer of each sequence appears in EXACTLY one window's extraction:
    a window starting at w yields k-mer starts [w, w+width-k], so the
    stride is width-k+1 (contiguous, non-overlapping start ranges).
    Returns (codes (R, L) uint8, lengths (R,) int32) as NumPy arrays,
    L = min(width, longest sequence)."""
    rows = []
    stride = max(1, width - k + 1)
    for s in seqs:
        if len(s) <= width:
            rows.append(s)
            continue
        for lo in range(0, len(s) - k + 1, stride):
            rows.append(s[lo:lo + width])
    return dna.encode_reads(rows)


def _phase_path(phase_dir: str, k: int) -> str:
    return os.path.join(phase_dir, f"pre_simplify_k{k}.npz")


def _save_phase_presimplify(phase_dir: str, k: int, g, v_space: int,
                            ginfo) -> None:
    """Checkpoint inside a K stage, just before simplification: a resumed
    run loads it and skips counting and construction; the finished stage
    removes it. Keys and dtypes are the JAX package's, so either package
    reads the other's file."""
    os.makedirs(phase_dir, exist_ok=True)
    arrays = interop.graph_to_saved_arrays(g)
    arrays["v_space"] = np.int64(v_space)
    arrays["ginfo_json"] = np.frombuffer(
        json.dumps(vars(ginfo)).encode(), np.uint8)
    # np.savez appends .npz when missing: keep the tmp name suffixed
    tmp = _phase_path(phase_dir, k) + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, _phase_path(phase_dir, k))


def _load_phase_presimplify(phase_dir: str, k: int, device):
    """(graph, v_space, genomic info) of the pre-simplify checkpoint, or
    None where there is none."""
    path = _phase_path(phase_dir, k)
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        arrays = {name: data[name] for name in interop.GRAPH_FIELDS
                  if name in data}
        ginfo = coverage_model.GenomicInfo(
            **json.loads(bytes(data["ginfo_json"])))
    g, v_space = compact_graph(interop.graph_from_numpy(arrays, k, device))
    return g, v_space, ginfo


def clear_phase_presimplify(phase_dir: str, k: int) -> None:
    with contextlib.suppress(OSError):
        os.remove(_phase_path(phase_dir, k))


def _construct(codes, lengths, k: int, min_kmer_count, extra_sequences,
               early_tip_clip: bool, device):
    """Construction (+ coverage model on the reads' (k+1)-mer spectrum):
    (compacted graph, v_space, genomic info). Tables are trimmed to
    pow2(unique) right away: every later shape scales with their
    capacity."""
    read_length = int(codes.shape[1])
    with _scope("count_kmers", device, k=k):
        kp1 = counter.trim_table(
            counter.count_kmers_chunked(codes, lengths, k + 1))
    with _scope("coverage_model_fit", device, k=k):
        ginfo = coverage_model.fit_coverage_model_hist(
            coverage_model.count_spectrum_device(kp1.counts, kp1.num))
    extra = [s for s in extra_sequences or () if len(s) > k]
    if extra:
        # contigs chopped into read-shaped rows, counted like reads
        with _scope("count_extra_contigs", device, k=k):
            ec, el = _windows_from_sequences(extra, read_length, k + 1)
            kp1 = counter.trim_table(counter.merge_tables(
                kp1, counter.trim_table(counter.count_kmers_chunked(
                    _to_device(ec, torch.uint8, device),
                    _to_device(el, torch.int32, device), k + 1))))
    if min_kmer_count == "auto":  # --cov-cutoff auto
        min_kmer_count = max(2, int(ginfo.ec_bound))
    if min_kmer_count > 1:
        kp1 = counter.trim_table(counter.filter_min_count(kp1, min_kmer_count))
    with _scope("vertex_table", device, k=k):
        vt = extension.trim_vertex_table(extension.build_vertex_table(kp1, k))
    if early_tip_clip and read_length > k + 1:
        # pre-graph tip clipping on the extension index (EarlyTipClipper;
        # bound defaults to RL - K)
        with _scope("early_tips", device, k=k):
            kp1, n_tips = early_tips.clip_early_tips(kp1, vt, k,
                                                     read_length - k)
            if n_tips:
                kp1 = counter.trim_table(kp1)
                vt = extension.trim_vertex_table(
                    extension.build_vertex_table(kp1, k))
    with _scope("condense", device, k=k):
        g = condense.build_graph(kp1, vt, k)
        del kp1, vt
        g, v_space = compact_graph(g)
    return g, v_space, ginfo


def assemble_single_k(codes, lengths, k: int,
                      cfg: runner.SimplifyConfig | None = None,
                      min_contig_length: int | None = None,
                      min_kmer_count: int | str = 1,
                      early_tip_clip: bool = True,
                      device: str | torch.device | None = None,
                      extra_sequences: list[str] | None = None,
                      restricted_sequences: list[str] | None = None,
                      uneven_depth: bool = False,
                      phase_dir: str | None = None) -> AssemblyResult:
    """Assemble one read batch at a single K.

    Args:
      codes/lengths: padded read batch (R, L) uint8 / (R,) int, as NumPy
        arrays or tensors.
      k: odd k-mer size (vertex size; edges from (k+1)-mers).
      cfg: simplification parameters (defaults mirror the reference's
        isolate mode).
      min_contig_length: drop contigs shorter than this (default 2k).
      min_kmer_count: drop (k+1)-mers seen fewer times; "auto" takes the
        coverage model's error bound. The filter runs after the extra
        sequences are merged in.
      device: where the assembly runs (``resolve_device``): the card by
        default, the CPU only on request, ``device="cpu"``.
      extra_sequences: more sequences fed into construction (the multi-K
        "--additional-contigs" mechanism): each of their (k+1)-mers
        counts once more. The coverage model is fitted on the reads'
        spectrum alone.
      restricted_sequences: the blackbird fork's restricted sequences
        (restricted_edges_filling.cpp:16-41): the edges their
        (k+1)-mers map to are never glued away by a bulge pass. The mask
        is mapped anew for every bulge pass (an edge index and one
        mapping), because recondensation renumbers edges.
      uneven_depth: take the error-connection bound from the graph
        (``ec_threshold.uneven_ec_bound``, the reference's meta/MDA
        GenomicInfoFiller branch) instead of the spectrum fit; not for a
        graph resumed from the pre-simplify checkpoint, whose bound was
        saved with it.
      phase_dir: directory of the pre-simplify checkpoint
        (``_save_phase_presimplify``).
    """
    if k % 2 == 0:
        raise ValueError(f"k must be odd (reference enforces this, "
                         f"projects/spades/main.cpp:101), got {k}")
    device = resolve_device(device, codes)
    codes = _to_device(codes, torch.uint8, device)
    lengths = _to_device(lengths, torch.int32, device)
    read_length = int(codes.shape[1])
    if cfg is None:
        cfg = runner.SimplifyConfig(read_length=read_length)

    loaded = (_load_phase_presimplify(phase_dir, k, device)
              if phase_dir else None)
    if loaded is not None:
        g, v_space, ginfo = loaded
        _log.info(f"k{k}: resumed from pre-simplify phase checkpoint "
                  f"(E2={g.capacity})")
    else:
        g, v_space, ginfo = _construct(codes, lengths, k, min_kmer_count,
                                       extra_sequences, early_tip_clip,
                                       device)
        if uneven_depth:
            # the spectrum mixture fit is unreliable under uneven depth
            # (genomic_info_filler.cpp:31-45, ec_threshold_finder.hpp:25)
            with _scope("uneven_ec_bound", device, k=k):
                ginfo = dataclasses.replace(
                    ginfo, ec_bound=ec_threshold.uneven_ec_bound(g))
        if phase_dir:
            with _scope("phase_checkpoint", device, k=k):
                _save_phase_presimplify(phase_dir, k, g, v_space, ginfo)

    _log.info(f"simplify entry shapes: E2={g.capacity} "
              f"flat={g.seq_flat.shape[0]} V={v_space} k={k} "
              f"ec_bound={float(ginfo.ec_bound):.3f}")
    protected_fn = None
    if restricted_sequences:
        def protected_fn(gr):
            return bio.fill_restricted_edges(gr, restricted_sequences)
    with _scope("simplify", device, k=k):
        g = runner.simplify_graph(g, v_space, ginfo.ec_bound, cfg,
                                  protected_fn=protected_fn)
    if phase_dir:
        clear_phase_presimplify(phase_dir, k)

    if min_contig_length is None:
        min_contig_length = 2 * k
    with _scope("graph_contigs", device, k=k):
        contigs = fasta.graph_contigs(g, min_length=min_contig_length)
    return AssemblyResult(
        contigs=contigs,
        genomic_info=ginfo,
        stats=construct.graph_stats(g),
        graph=g,
    )


# Reference default K ladders (spades_pipeline/options_storage.py:62-77)
K_MERS_SHORT = [21, 33, 55]
K_MERS_150 = [21, 33, 55, 77]
K_MERS_250 = [21, 33, 55, 77, 99, 127]


def default_k_ladder(read_length: int) -> list[int]:
    """Auto K selection from read length (spades_stage.py:41-120)."""
    if read_length >= 250:
        return K_MERS_250
    if read_length >= 150:
        return K_MERS_150
    return K_MERS_SHORT


def repeat_resolution(g, codes1, lengths1, codes2, lengths2,
                      with_scaffolds: bool = False,
                      estimator: str = "simple", device=None):
    """exSPAnder repeat resolution over the final graph using one
    paired library (the RepeatResolution stage,
    projects/spades/repeat_resolving.cpp:62). See
    ``repeat_resolution_multi`` for the per-library model."""
    kind = "mp" if estimator == "smoothing" else "pe"
    return repeat_resolution_multi(
        g, [(codes1, lengths1, codes2, lengths2, kind)],
        with_scaffolds=with_scaffolds, device=device)


def repeat_resolution_multi(g, libs, with_scaffolds: bool = False,
                            lib_data_out: list | None = None,
                            scaffold_graph_out: dict | None = None,
                            scaffolding_estimator: str | None = None,
                            long_reads=None,
                            paths_out: dict | None = None,
                            device=None):
    """Per-library repeat resolution (pair_info_count.cpp:186-230 +
    extenders_logic.cpp per-lib extender construction): each library
    gets its OWN insert-size estimate, paired-index shift and distance
    estimator (simple for PE, multi-peak smoothing for MP,
    distance_estimation.cpp estimator choice per library type), then all
    feed the composite extender.

    ``libs``: list of (codes1, lengths1, codes2, lengths2, kind) with
    kind in {"pe", "mp"}; second mates as read (FR orientation after
    read conversion), reverse-complemented here to face downstream.

    The JAX package's single-device branch: the index, the mapping, the
    insert-size histogram, the paired index and its distance estimate run
    on ``device`` (``resolve_device``: the card unless ``"cpu"`` is asked
    for; the graph and reads are moved there); split-path filling, path
    extension, loop traversal, scaffolding and polishing run on the host,
    on one copy of the graph. ``long_reads`` ((codes, lengths), the
    hybrid branch) are aligned to the graph (``long_read.align_long_reads``)
    and their edge paths of two edges or more guide extension first (the
    LongReadsExtensionChooser, extenders_logic.cpp:469). Scaffolding
    takes its gap thresholds from the paired libraries alone: the JAX
    package reads the long-read library's insert size there, which it
    has not, and raises (ROADMAP.md, Queue 3). With
    ``scaffolding_estimator="weighted"`` the scaffolder takes a separate
    index from each paired library: the raw index snapped to graph path
    lengths with the insert-size weight function
    (``pair_info.weighted_cluster_distances``, the reference's
    estimate_scaffolding_distance, distance_estimation.cpp:100-135).
    """
    device = resolve_device(device, g.seq_flat)
    g = g.to(device)
    k = g.k
    with _scope("rr_build_index", device):
        idx = eidx.build_edge_index(g, k + 1, device=device)

    def chain_map(c, l):
        ch = chunked.map_reads_multi_chunked(
            idx, g.seq_len, c, l, k + 1, min_votes=1, device=device)
        return mapper.normalize_chain(ch, g.conj)

    def first_placement(ch):
        return mapper.ReadMapping(
            oriented_edge=ch.oriented_edge[:, 0], start=ch.start[:, 0],
            votes=ch.votes[:, 0], mapped=ch.mapped)

    libs = [(_to_device(c1, torch.uint8, device),
             _to_device(l1, torch.int32, device),
             _to_device(c2, torch.uint8, device),
             _to_device(l2, torch.int32, device), kind)
            for c1, l1, c2, l2, kind in libs]
    total_bases = float(sum(int(l1.sum()) + int(l2.sum())
                            for _, l1, _, l2, _ in libs)) or 1.0
    hv = host_view(g)
    specs = []
    clustered_all = []
    for codes1, lengths1, codes2, lengths2, kind in libs:
        c2rc = dna.revcomp_reads(codes2, lengths2)
        # chain mappings: junction-spanning reads place on EVERY
        # traversed edge (the MappingPath equivalent); pair filling
        # uses all edge combinations + split-read adjacency pairs
        with _scope("rr_map_reads", device):
            ch1 = chain_map(codes1, lengths1)
            ch2 = chain_map(c2rc, lengths2)
        del c2rc
        stats = insert_size.estimate_insert_size(
            first_placement(ch1), first_placement(ch2), lengths2)
        read_length = max(int(lengths1.max()) if lengths1.numel() else 0,
                          int(lengths2.max()) if lengths2.numel() else 0)
        if lib_data_out is not None:
            # the final.lib_data equivalent (pipeline.cpp:288
            # write_lib_data): estimated per-lib parameters
            lib_data_out.append({
                "kind": kind,
                "read_length": read_length,
                "insert_size_median": float(stats.median),
                "insert_size_mad": float(stats.mad),
                "pairs_used": int(stats.count),
            })
        if stats.count == 0:
            continue
        mean_l2 = int(lengths2.sum()) / lengths2.shape[0]
        with _scope("rr_pair_fill", device):
            pi = pair_info.fill_paired_index_multi_chunked(
                ch1, ch2, int(round(stats.median - mean_l2)))
        del ch1, ch2
        spread = max(5, int(3 * stats.mad))
        if kind == "mp":
            # mate pairs: broad, multi-modal histograms -> multi-peak
            # smoothing estimator (smoothing_distance_estimation.hpp:19)
            clustered = pair_info.host_index(
                pair_info.cluster_distances_smoothing(
                    pi, max(spread, 20), 2.0))
        else:
            clustered = pair_info.cluster_distances(pi, spread)
            # PairInfoImprover's FillMissing on the clustered PE index
            # (distance_estimation.cpp:161 + pair_info_improver.hpp:215):
            # split-path derivation along forced path suffixes only
            clustered = pair_info.split_path_fill(
                hv, clustered, float(stats.median), float(stats.deviation))
        share = float(int(lengths1.sum()) + int(lengths2.sum())) / total_bases
        specs.append(resolver.LibSpec(
            clustered, is_stats=stats, read_length=read_length,
            kind=kind, coverage_share=share))
        if scaffolding_estimator == "weighted" and stats.histogram:
            clustered_all.append(pair_info.weighted_cluster_distances(
                hv, pi, stats.histogram, float(stats.median),
                float(stats.deviation)))
        else:
            clustered_all.append(clustered)
    del idx

    if long_reads is not None:
        # long reads guide extension too (the aligned PathStorage of
        # the hybrid stages; extenders_logic.cpp:469 adds long-read
        # extenders before the paired ones)
        lc, ll = long_reads
        with _scope("rr_align_long_reads", device):
            alns = long_read.align_long_reads(g, lc, ll, device=device)
        lr_paths = [(a.edge_path, 1.0) for a in alns
                    if len(a.edge_path) >= 2]
        if lr_paths:
            specs.append(resolver.LibSpec(
                None, kind="long", read_paths=lr_paths))

    if not specs:
        rows = fasta.graph_contigs(g, min_length=2 * k, with_edges=True)
        contigs = [(s, c) for s, c, _ in rows]
        if paths_out is not None:
            paths_out["contigs"] = [[e] for _, _, e in rows]
            paths_out["scaffolds"] = [[(e, 0)] for _, _, e in rows]
        return (contigs, contigs) if with_scaffolds else contigs

    with _scope("rr_resolve_paths", device):
        ps = resolver.resolve_paths_multi(hv, specs)
    # tandem-repeat traversal after extension (launcher.cpp:301
    # TraverseLoops): joins surface as k+100 N gaps in scaffolds
    loop_joins = loop_traverser.traverse_loops(hv, ps)
    crows = resolver.paths_to_contigs(hv, ps, with_paths=True)
    contigs = [(s, c) for s, c, _ in crows]
    if paths_out is not None:
        paths_out["contigs"] = [p for _, _, p in crows]
    if not with_scaffolds:
        return contigs
    paired = [s for s in specs if s.kind != "long"]
    if not paired:  # long reads alone: no pair evidence to scaffold with
        if paths_out is not None:
            paths_out["scaffolds"] = [[(e, 0) for e in p]
                                      for p in paths_out["contigs"]]
        return contigs, contigs
    merged = pair_info.merge_paired_indices(clustered_all)
    # gap-analysis thresholds scale with the (largest) library IS
    # variation (extenders_logic.cpp:105-107 MakeGapAnalyzer)
    sparams = scaffolder.ScaffoldParams(
        is_variation=max(float(s.is_stats.deviation) for s in paired),
        read_length=max(s.read_length for s in paired))
    with _scope("rr_scaffold", device):
        chains = scaffolder.scaffold_paths(hv, ps, merged, params=sparams,
                                           forced_joins=loop_joins,
                                           sg_out=scaffold_graph_out)
        # gap polishing: unique graph paths replace N runs
        # (scaffolder2015/path_polisher.cpp)
        chains, _ = polisher.polish_scaffolds(hv, chains)
    srows = scaffolder.scaffolds_to_contigs(hv, chains, with_paths=True)
    scaffolds = [(s, c) for s, c, _ in srows]
    if paths_out is not None:
        paths_out["scaffolds"] = [p for _, _, p in srows]
    return contigs, scaffolds


def assemble_multi_k(codes, lengths, ks: list[int] | None = None,
                     cfg: runner.SimplifyConfig | None = None,
                     min_contig_length: int | None = None,
                     device: str | torch.device | None = None
                     ) -> AssemblyResult:
    """Iterative multi-K assembly (the spades.py per-K loop): each K's
    contigs seed the next K's construction. The reads go to the device
    once; between rungs only the contig strings stay, so one rung's graph
    is released before the next is built."""
    device = resolve_device(device, codes)
    codes = _to_device(codes, torch.uint8, device)
    lengths = _to_device(lengths, torch.int32, device)
    if ks is None:
        ks = [k for k in default_k_ladder(int(codes.shape[1]))
              if k < int(codes.shape[1])]
    result = None
    prev_contigs: list[str] = []
    for k in ks:
        result = None  # release the last rung's graph first
        result = assemble_single_k(
            codes, lengths, k, cfg=cfg,
            min_contig_length=min_contig_length,
            extra_sequences=prev_contigs, device=device)
        prev_contigs = [s for s, _ in result.contigs]
    return result
