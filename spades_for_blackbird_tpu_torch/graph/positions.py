"""Edge position tracking: where graph edges sit in named sequences.

PyTorch counterpart of the JAX package's ``graph/positions.py`` (the
reference's ``EdgePositionHandler``,
assembly_graph/handlers/edges_position_handler.hpp:22: in developer mode
every edge records the (reference, range, strand) intervals it aligns
to, feeding detail printers and debugging). Every (k+1)-mer of a named
sequence looks itself up in the edge k-mer index through the k-mer
kernel's strand entry, as ``mapping/mapper.py`` does: the sequence is
cut into rows of at most ``kmer_cuda.MAX_L`` bases that overlap by k
(``index.flat_rows``), so the windows of the rows are the sequence's
windows in order. Colinear runs of (edge, offset) hits then compress
into ranges on the host. The JAX package's power-of-two chunks, which
exist only to reuse compiles, are not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kmers import counter
from ..mapping import index as eidx
from ..ops import dna
from ..utils.device import resolve_device
from .graph import Graph


@dataclass
class EdgeRange:
    name: str       # sequence name
    seq_start: int  # range in the named sequence (bases)
    seq_end: int
    edge_start: int  # matching range start within the edge
    is_fwd: bool    # sequence runs along the edge's stored orientation


def _lookup(idx: eidx.EdgeKmerIndex, codes: torch.Tensor, k: int):
    """(edge, offset, fwd, found) of each k-window of one sequence's codes
    (a (L,) uint8 tensor), as host arrays of L - k + 1 entries."""
    n_kmers = codes.shape[0] - k + 1
    rows, lengths = eidx.flat_rows(codes, codes.shape[0], k)
    found, row, read_fwd = counter.lookup_windows(idx.hay(), idx.num,
                                                  rows, lengths, k)
    found, row, read_fwd = (x.reshape(-1)[:n_kmers]
                            for x in (found, row, read_fwd))
    return (idx.edge[row].cpu().numpy(), idx.offset[row].cpu().numpy(),
            (read_fwd == idx.is_fwd[row]).cpu().numpy(),
            found.cpu().numpy())


def fill_edge_positions(g: Graph, sequences: dict[str, str], device=None
                        ) -> dict[int, list[EdgeRange]]:
    """Map every named sequence onto the graph; returns per-edge ranges.
    The index and the lookups run on ``device`` (``resolve_device``: by
    default the graph's card, else the first card; the CPU only on
    request)."""
    device = resolve_device(device, g.seq_flat)
    g = g.to(device)
    k = g.k
    idx = eidx.build_edge_index(g, k + 1, device=device)
    positions: dict[int, list[EdgeRange]] = {}

    for name, seq in sequences.items():
        L = len(seq)
        if L < k + 1:
            continue
        n_kmers = L - k
        if idx.capacity == 0:
            continue
        codes = torch.from_numpy(dna.encode_str(seq)).to(device)
        edges, offs, fwd, found_all = _lookup(idx, codes, k + 1)

        # colinear run-length encode: same edge, same strand, stored
        # offset advancing +1 along the edge (fwd) / -1 (rc)
        same = (edges[1:] == edges[:-1]) & (fwd[1:] == fwd[:-1]) & \
            found_all[1:] & found_all[:-1] & \
            (offs[1:] - offs[:-1] == np.where(fwd[1:], 1, -1))
        breaks = np.nonzero(~same)[0]
        starts = np.concatenate([[0], breaks + 1])
        ends = np.concatenate([breaks, [n_kmers - 1]])
        for s, e in zip(starts, ends):
            if not found_all[s]:
                continue
            edge = int(edges[s])
            r = EdgeRange(
                name=name, seq_start=int(s), seq_end=int(e) + k + 1,
                edge_start=int(min(offs[s], offs[e])),
                is_fwd=bool(fwd[s]))
            positions.setdefault(edge, []).append(r)
    return positions


def positions_table(g: Graph, sequences: dict[str, str], device=None
                    ) -> list[str]:
    """TSV lines 'edge  name  seq_start-seq_end  edge_start  strand'
    (the detail printer's position dump)."""
    pos = fill_edge_positions(g, sequences, device=device)
    out = []
    for e in sorted(pos):
        for r in pos[e]:
            out.append(f"{e}\t{r.name}\t{r.seq_start}-{r.seq_end}\t"
                       f"{r.edge_start}\t{'+' if r.is_fwd else '-'}")
    return out
