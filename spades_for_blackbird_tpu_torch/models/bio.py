"""The blackbird fork's restricted edges.

PyTorch counterpart of ``fill_restricted_edges`` and
``load_restricted_fasta`` in the JAX package's ``models/bio.py``
(restricted_edges_filling.cpp:16-41): the edges a set of sequences runs
through are protected from bulge removal, so an allele the caller asks
about survives simplification. The HMM domain matching of that module
(biosyntheticSPAdes) is not ported yet.
"""

from __future__ import annotations

import os

import torch

from ..graph.graph import Graph, edge_mask
from ..mapping import index as eidx
from ..mapping import mapper
from ..ops import dna, kmer_cuda


def _rows(seqs: list[str], k: int) -> list[str]:
    """The sequences cut into rows of at most ``kmer_cuda.MAX_L`` bases
    that overlap by k - 1, so every k-mer of a sequence lies in a row."""
    stride = kmer_cuda.MAX_L - k + 1
    return [s[lo:lo + kmer_cuda.MAX_L] for s in seqs
            for lo in range(0, len(s) - k + 1, stride)]


def fill_restricted_edges(g: Graph, seqs: list[str]) -> torch.Tensor:
    """Edges ((E,) bool on the graph's device, conjugate-closed) that any
    (k+1)-mer of the sequences maps to (MapSequence().simple_path() over
    restricted_edges.fasta, inserting each edge and its conjugate)."""
    k = g.k
    mask = torch.zeros(g.capacity, dtype=torch.bool, device=g.device)
    seqs = [s for s in seqs if len(s) > k]
    if not seqs:
        return mask
    idx = eidx.build_edge_index(g, k + 1, device=g.device)
    codes, lengths = dna.encode_reads(_rows(seqs, k + 1))
    edge, _, _, found = mapper.map_kmers(
        idx, torch.from_numpy(codes).to(g.device),
        torch.from_numpy(lengths).to(g.device), k + 1)
    edges = edge[found]
    mask[edges] = True
    mask[g.conj[edges]] = True
    return mask & edge_mask(g)


def load_restricted_fasta(path: str) -> list[str]:
    """The sequences of a FASTA file (restricted_edges.fasta); none when
    the file is missing."""
    seqs = []
    if not os.path.exists(path):
        return seqs
    cur = []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                cur = []
            else:
                cur.append(line.strip())
    if cur:
        seqs.append("".join(cur))
    return seqs
