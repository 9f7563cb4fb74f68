"""Single-K assembly and the K ladder: reads -> simplified graph -> contigs.

PyTorch counterpart of ``spades_for_blackbird_tpu/pipeline/assemble.py``,
single-device branch. ``assemble_single_k`` counts (k+1)-mers, fits the
coverage model, builds the vertex table, clips early tips, condenses
unitigs, compacts, simplifies and emits contigs (the reference's per-K
Construction -> GenomicInfoFiller -> Simplification -> ContigOutput).
``assemble_multi_k`` runs it once per K, each rung's contigs fed into the
next rung's construction.
"""

from __future__ import annotations

import contextlib
import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import interop
from ..graph import condense, construct
from ..graph.graph import compact_graph
from ..io import fasta
from ..kmers import counter, coverage_model, early_tips, extension
from ..ops import dna
from ..simplify import runner
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
      phase_dir: directory of the pre-simplify checkpoint
        (``_save_phase_presimplify``).

    ``restricted_sequences`` and ``uneven_depth=True`` are not ported yet
    and raise NotImplementedError.
    """
    for name, value in (("restricted_sequences", restricted_sequences),
                        ("uneven_depth", uneven_depth)):
        if value:
            raise NotImplementedError(
                f"assemble_single_k({name}=...) is not ported to PyTorch "
                f"yet (ROADMAP.md, Queue 1, 'Still to port')")
    if k % 2 == 0:
        raise ValueError(f"k must be odd (reference enforces this, "
                         f"projects/spades/main.cpp:101), got {k}")
    device = resolve_device(device, codes)
    codes = _to_device(codes, torch.uint8, device)
    lengths = _to_device(lengths, torch.int32, device)
    read_length = int(codes.shape[1])
    if cfg is None:
        cfg = runner.SimplifyConfig(read_length=read_length)
    runner.check_ported(cfg)

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
        if phase_dir:
            with _scope("phase_checkpoint", device, k=k):
                _save_phase_presimplify(phase_dir, k, g, v_space, ginfo)

    _log.info(f"simplify entry shapes: E2={g.capacity} "
              f"flat={g.seq_flat.shape[0]} V={v_space} k={k} "
              f"ec_bound={float(ginfo.ec_bound):.3f}")
    with _scope("simplify", device, k=k):
        g = runner.simplify_graph(g, v_space, ginfo.ec_bound, cfg)
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
