"""Sharded graph construction: the distributed extension-index build.

PyTorch counterpart of the JAX package's ``parallel/construction.py``
(the reference's ExtensionIndexBuilder, kmer_extension_index_builder.hpp:
45-60): every (k+1)-mer of a rank's partition emits two (k-mer, mask
bit) records (its prefix an out bit, its suffix an in bit, both
redirected through canonicalisation as in ``kmers/extension.py``); the
records go to their owner rank by k-mer hash; each owner sorts and
reduces its records into its partition of the canonical vertex table.
The bit rides inside the exchanged row, one int64 column after the W
k-mer words, so one exchange moves keys and payloads together.
"""

from __future__ import annotations

import torch

from ..kmers import extension
from ..kmers.counter import KmerTable
from ..kmers.extension import VertexTable
from ..ops import dna, segments
from .kmer_exchange import owner_of
from .mesh import Mesh


def _pow2_vertex_table(kmers, out_mask, in_mask) -> VertexTable:
    """A vertex table of these real rows (sorted), padded to the power
    of two at or above their number (``extension.trim_vertex_table``'s
    capacity)."""
    num = kmers.shape[0]
    cap = 1 << max(1, num - 1).bit_length()
    dev = kmers.device
    out_k = torch.full((cap, kmers.shape[1]), dna.WORD_MASK,
                       dtype=torch.int64, device=dev)
    om = torch.zeros(cap, dtype=torch.uint8, device=dev)
    im = torch.zeros(cap, dtype=torch.uint8, device=dev)
    out_k[:num], om[:num], im[:num] = kmers, out_mask, in_mask
    return VertexTable(out_k, om, im, torch.tensor(num, device=dev))


def make_sharded_vertex_builder(mesh: Mesh, k: int):
    """``build(kp1) -> VertexTable``: this rank's partition of the
    (k+1)-mer table (``make_sharded_counter``) in, this rank's partition
    of the canonical k-mer vertex table out: the k-mers with
    ``hash % D == rank``, sorted, with their extension masks."""
    def build(kp1: KmerTable) -> VertexTable:
        n = int(kp1.num)
        prefix, suffix, first, last = extension.kplus1_prefix_suffix(
            kp1.kmers[:n], k)
        cpre, pre_fwd = dna.canonicalize_kmers(prefix, k)
        csuf, suf_fwd = dna.canonicalize_kmers(suffix, k)
        first, last = first.to(torch.int64), last.to(torch.int64)
        # bit columns of kmers/extension.py: 0..3 out, 4..7 in
        pre_col = torch.where(pre_fwd, last, 4 + (3 - last))
        suf_col = torch.where(suf_fwd, 4 + first, 3 - first)
        keys = torch.cat([cpre, csuf])
        rows = torch.cat([keys, torch.cat([pre_col, suf_col])[:, None]],
                         dim=1)
        got, _ = mesh.exchange(rows, owner_of(mesh, keys))
        W = keys.shape[1]
        M = got.shape[0]
        if M == 0:
            return _pow2_vertex_table(got[:, :W],
                                      got.new_zeros(0, dtype=torch.uint8),
                                      got.new_zeros(0, dtype=torch.uint8))
        # local reduce: unique k-mers, OR of the bit columns
        skeys, (scol,), svalid = segments.sort_by_key_rows(
            got[:, :W], (got[:, W],),
            torch.ones(M, dtype=torch.bool, device=got.device))
        uniq, _, gid, num = segments.unique_counts(skeys, svalid)
        num = int(num)
        bits = torch.zeros(num * 8, dtype=torch.uint8, device=got.device)
        bits[gid * 8 + scol] = 1
        bits = bits.view(num, 8).to(torch.int64)
        weights = 1 << torch.arange(4, device=got.device)
        return _pow2_vertex_table(
            uniq[:num], (bits[:, :4] * weights).sum(1).to(torch.uint8),
            (bits[:, 4:] * weights).sum(1).to(torch.uint8))
    return build


def gather_vertex_table(mesh: Mesh, vt: VertexTable) -> VertexTable:
    """Every rank's vertex partition merged into one sorted VertexTable
    on every rank (for stages that take the whole table)."""
    n = int(vt.num)
    W = vt.kmers.shape[1]
    rows = mesh.gather_cat(torch.cat(
        [vt.kmers[:n], vt.out_mask[:n, None].to(torch.int64),
         vt.in_mask[:n, None].to(torch.int64)], dim=1))
    perm = segments.lexsort_perm(segments.fuse_words(rows[:, :W]))
    rows = rows[perm]
    return _pow2_vertex_table(rows[:, :W], rows[:, W].to(torch.uint8),
                              rows[:, W + 1].to(torch.uint8))
