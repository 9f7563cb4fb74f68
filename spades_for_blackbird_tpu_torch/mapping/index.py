"""Edge k-mer index: canonical k-mer -> (edge, offset, strand).

PyTorch counterpart of the JAX package's ``mapping/index.py``
(the reference's edge-position index, assembly_graph/index/
edge_position_index.hpp ``KmerStoringEdgeIndex``): every k-mer of every
alive edge, sorted by its canonical form, with its edge id, the offset
of its first base in the edge's sequence, and whether the canonical form
is the edge's own orientation. A k-mer in several edges keeps a row for
each, in the order of the graph's flat sequence buffer; a lookup finds
the first of them.

The canonical k-mers come from the extraction kernel's strand entry
(``ops/kmer_cuda.extract_canonical_keys``), which the JAX package does
not use here (it calls ``kmer.extract_kmers`` and
``dna.canonicalize_kmers`` on the whole buffer as one read). The kernel
takes rows of at most ``kmer_cuda.MAX_L`` bases, so the buffer is cut
into rows of width w that overlap by k - 1 bases; a row's w - k + 1
windows then start at w - k + 1 consecutive flat positions, and the
kernel's window order is the flat order. Keys are kept as the kernel
writes them: ``segments.fused_cols`` of the canonical words, with the
fused all-ones sentinel in every row that is not an edge's k-mer (no
canonical k-mer is all-ones: its reverse complement, all A, is smaller).
The sort is stable, so equal k-mers keep the flat order, as in the JAX
package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..graph.graph import Graph, edge_mask, slot_owner
from ..ops import dna, kmer_cuda, segments
from ..utils.device import resolve_device


class EdgeKmerIndex(NamedTuple):
    keys: torch.Tensor     # (G, N) int64 sorted fused canonical keys
    edge: torch.Tensor     # (N,) int64 edge id
    offset: torch.Tensor   # (N,) int64 first-base offset within the edge
    is_fwd: torch.Tensor   # (N,) bool canonical orientation == edge's
    num: torch.Tensor      # () int64 rows that are edge k-mers
    k: int

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]

    def hay(self) -> list[torch.Tensor]:
        """The key columns, as ``segments.search_keys`` takes them."""
        return list(self.keys.unbind(0))


def flat_rows(flat: torch.Tensor, n: int, k: int):
    """Rows of width w <= MAX_L over ``flat[:n]``, overlapping by k - 1,
    so that row r's windows are flat positions [r*s, (r+1)*s), s = w-k+1.
    Returns (codes (R, w) uint8, lengths (R,) int32)."""
    w = min(kmer_cuda.MAX_L, n)
    stride = w - k + 1
    rows = -(-(n - k + 1) // stride)
    span = (rows - 1) * stride + w
    padded = torch.full((span,), dna.INVALID_CODE, dtype=torch.uint8,
                        device=flat.device)
    padded[:n] = flat[:n]
    codes = padded.unfold(0, w, stride).contiguous()
    lo = torch.arange(rows, device=flat.device) * stride
    lengths = torch.clamp(n - lo, max=w).to(torch.int32)
    return codes, lengths


def build_edge_index(g: Graph, k: int, device=None) -> EdgeKmerIndex:
    """Index every k-mer of every alive edge (edge_index_refiller.cpp).
    Runs on ``device`` (``resolve_device``: the card unless ``"cpu"`` is
    asked for); the graph is moved there first."""
    device = resolve_device(device, g.seq_flat)
    g = g.to(device)
    m = edge_mask(g)
    ends = torch.where(m, g.seq_start + g.seq_len, 0)
    n = int(ends.max()) if g.capacity else 0
    G = (dna.words_per_kmer(k) + 1) // 2
    if n < k:
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        return EdgeKmerIndex(torch.zeros((G, 0), dtype=torch.int64,
                                         device=device),
                             empty, empty, empty.bool(),
                             torch.zeros((), dtype=torch.int64,
                                         device=device), k)
    # owner of each flat slot; a k-mer starting there stays in its edge
    slot_edge = slot_owner(g.seq_start, m, n)
    se = torch.clamp(slot_edge, min=0)
    pos_in_edge = torch.arange(n, device=device) - g.seq_start[se]
    ok = ((slot_edge >= 0) & m[se] & (pos_in_edge >= 0)
          & (pos_in_edge + k <= g.seq_len[se]))
    P = n - k + 1
    codes, lengths = flat_rows(g.seq_flat, n, k)
    keys, valid, is_fwd = kmer_cuda.extract_canonical_keys(codes, lengths, k)
    ok = ok[:P]
    if valid is not None:
        ok &= valid[:P]
    sentinel = torch.tensor(segments.fused_sentinels(dna.words_per_kmer(k)),
                            dtype=torch.int64, device=device)[:, None]
    keys = torch.where(ok[None, :], keys[:, :P], sentinel)
    perm = segments.lexsort_perm(list(keys.unbind(0)))
    return EdgeKmerIndex(keys[:, perm], se[:P][perm], pos_in_edge[:P][perm],
                         is_fwd[:P][perm], ok.sum(), k)


def lookup_kmers(index: EdgeKmerIndex, queries: torch.Tensor):
    """Find canonical query k-mers (M, W) words.

    Returns (row (M,), found (M,), edge (M,), offset (M,)) using the first
    matching row (unique-mapping k-mers have exactly one)."""
    row = segments.search_keys(index.hay(), segments.fuse_words(queries))
    found = row < index.num
    safe = torch.where(found, row, 0)
    if index.capacity == 0:
        return row, found, torch.zeros_like(row), torch.zeros_like(row)
    return row, found, index.edge[safe], index.offset[safe]
