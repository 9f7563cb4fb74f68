"""End-to-end graph construction (reads -> condensed de Bruijn graph),
the standalone corrector's trivial graph, and graph summary statistics.

PyTorch counterpart of the JAX package's ``graph/construct.py`` (the
reference's Construction stage, assembler/src/common/stages/
construction.cpp:469-484: KMerCounting -> ExtensionIndexBuilder ->
GraphCondenser -> PHMCoverageFiller).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kmers import counter, extension
from ..ops import dna
from ..utils.device import resolve_device
from . import condense
from .graph import Graph, edge_mask


def graph_from_reads(codes, lengths, k: int, min_count: int = 1,
                     device=None) -> Graph:
    """Build the condensed graph from a read batch: (R, L) uint8 codes
    and (R,) lengths, NumPy or tensors. Edges are built from
    (k+1)-mers (the reference's extension index counts (k+1)-mers,
    kmer_extension_index_builder.hpp:45); ``min_count`` drops
    (k+1)-mers seen fewer times. Runs on ``device`` (``resolve_device``:
    the card unless ``"cpu"`` is asked for)."""
    device = resolve_device(device, codes)
    codes = torch.as_tensor(codes).to(device=device, dtype=torch.uint8)
    lengths = torch.as_tensor(lengths).to(device=device, dtype=torch.int32)
    kp1 = counter.count_kmers(codes, lengths, k + 1)
    if min_count > 1:
        kp1 = counter.filter_min_count(kp1, min_count)
    vt = extension.trim_vertex_table(extension.build_vertex_table(kp1, k))
    return condense.build_graph(kp1, vt, k)


def graph_from_sequences(seqs: list[str], k: int, device=None) -> Graph:
    """Trivial graph: one conjugate edge pair per sequence (edge 2i the
    sequence, 2i + 1 its reverse complement), fresh vertices, no gluing.
    Used by the standalone corrector, which polishes given contigs
    rather than a de Bruijn graph (projects/corrector/
    dataset_processor.cpp:173 splits contigs and processes each
    independently). Built on ``device`` (``resolve_device``)."""
    device = resolve_device(device)
    E = 2 * len(seqs)
    lens = np.zeros(E, np.int64)
    codes = []
    for i, s in enumerate(seqs):
        c = dna.encode_str(s)
        codes += [c, dna.revcomp_codes(c)]
        lens[2 * i] = lens[2 * i + 1] = len(s)
    flat = np.concatenate(codes) if codes else np.zeros(1, np.uint8)
    starts = np.cumsum(lens) - lens
    # conjugate vertex pairing: start(e) conj = end(conj e)
    i = np.arange(len(seqs), dtype=np.int64)
    start_v = np.stack([4 * i, 4 * i + 3], 1).reshape(-1)
    end_v = np.stack([4 * i + 2, 4 * i + 1], 1).reshape(-1)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)
    return Graph(
        seq_flat=t(flat), seq_start=t(starts), seq_len=t(lens),
        cov=torch.zeros(E, dtype=torch.float32, device=device),
        start_v=t(start_v), end_v=t(end_v),
        conj=t(np.arange(E, dtype=np.int64) ^ 1),
        alive=torch.ones(E, dtype=torch.bool, device=device),
        num_edges=torch.tensor(E, dtype=torch.int64, device=device), k=k)


def graph_stats(g: Graph) -> dict:
    """Host-side summary stats (edge count, total length, N50-ish)."""
    alive = edge_mask(g).cpu().numpy()
    lens = g.seq_len.cpu().numpy()[alive]
    covs = g.cov.cpu().numpy()[alive]
    if lens.size == 0:
        return {"edges": 0, "total_len": 0, "max_len": 0, "mean_cov": 0.0}
    slens = np.sort(lens)[::-1]
    half = slens.sum() / 2
    n50 = int(slens[np.cumsum(slens) >= half][0])
    return {
        "edges": int(alive.sum()),
        "total_len": int(lens.sum()),
        "max_len": int(lens.max()),
        "n50": n50,
        "mean_cov": float((covs * lens).sum() / lens.sum()),
    }
