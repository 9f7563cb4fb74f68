"""Single-K assembly pipeline: reads -> simplified graph -> contigs.

PyTorch counterpart of ``assemble_single_k`` in
``spades_for_blackbird_tpu/pipeline/assemble.py``, single-device branch:
count (k+1)-mers, fit the coverage model, build the vertex table, clip
early tips, condense unitigs, compact, simplify, emit contigs (the
reference's per-K Construction -> GenomicInfoFiller -> Simplification ->
ContigOutput).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from ..graph import condense, construct
from ..graph.graph import compact_graph
from ..io import fasta
from ..kmers import counter, coverage_model, early_tips, extension
from ..simplify import runner
from ..utils import timetrace
from ..utils.logger import get_logger

_log = get_logger("Assembler")


@dataclass
class AssemblyResult:
    contigs: list[tuple[str, float]]
    genomic_info: coverage_model.GenomicInfo
    stats: dict
    graph: object = None  # final simplified Graph


@contextlib.contextmanager
def _scope(name: str, device: torch.device, **args):
    """timetrace scope that, while tracing is on, waits for the card at
    its end, so the span holds the device work and not only its launch."""
    with timetrace.scope(name, **args):
        yield
        if timetrace.enabled() and device.type == "cuda":
            torch.cuda.synchronize(device)


def _to_device(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


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
        coverage model's error bound.
      device: where the assembly runs. By default the card: the
        device of ``codes`` when that is a tensor on a card, else
        ``cuda``; without a card the call raises. The CPU is taken
        only on request, ``device="cpu"``.

    ``extra_sequences``, ``restricted_sequences``, ``uneven_depth=True``
    and ``phase_dir`` are not ported yet and raise NotImplementedError.
    """
    for name, value in (("extra_sequences", extra_sequences),
                        ("restricted_sequences", restricted_sequences),
                        ("uneven_depth", uneven_depth),
                        ("phase_dir", phase_dir)):
        if value:
            raise NotImplementedError(
                f"assemble_single_k({name}=...) is not ported to PyTorch "
                f"yet (ROADMAP.md, Queue 1, 'Still to port')")
    if k % 2 == 0:
        raise ValueError(f"k must be odd (reference enforces this, "
                         f"projects/spades/main.cpp:101), got {k}")
    if device is None:
        on_card = isinstance(codes, torch.Tensor) and codes.is_cuda
        device = codes.device if on_card else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "assemble_single_k runs on a CUDA card by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    codes = _to_device(codes, torch.uint8, device)
    lengths = _to_device(lengths, torch.int32, device)
    read_length = int(codes.shape[1])
    if cfg is None:
        cfg = runner.SimplifyConfig(read_length=read_length)
    runner.check_ported(cfg)

    # Construction (+ coverage model on the (k+1)-mer spectrum). The
    # table is trimmed to pow2(unique) right away: every later shape
    # scales with its capacity.
    with _scope("count_kmers", device, k=k):
        kp1 = counter.trim_table(
            counter.count_kmers_chunked(codes, lengths, k + 1))
    with _scope("coverage_model_fit", device, k=k):
        ginfo = coverage_model.fit_coverage_model_hist(
            coverage_model.count_spectrum_device(kp1.counts, kp1.num))
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

    _log.info(f"simplify entry shapes: E2={g.capacity} "
              f"flat={g.seq_flat.shape[0]} V={v_space} k={k} "
              f"ec_bound={float(ginfo.ec_bound):.3f}")
    with _scope("simplify", device, k=k):
        g = runner.simplify_graph(g, v_space, ginfo.ec_bound, cfg)

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
