"""Extension index: canonical k-mer vertex table with in/out nucleotide masks.

PyTorch counterpart of the JAX package's ``kmers/extension.py``:
from the unique (k+1)-mer table, derive the k-mer set and a 4-bit out
mask and 4-bit in mask per canonical k-mer.

Orientation convention: a k-mer traversed in its non-canonical
orientation has out-mask = bit-reversed in-mask of the canonical record
(bit c <-> bit 3-c), and vice versa.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import dna, segments
from .counter import KmerTable


class VertexTable(NamedTuple):
    """Sorted canonical k-mers with extension masks (padded ragged).

    kmers: (N, W) int64 sorted canonical k-mers (all-ones padding).
    out_mask: (N,) uint8 -- bit c set iff the canonical k-mer extends
      right with base c.
    in_mask: (N,) uint8 -- bit c set iff base c precedes it.
    num: 0-dim int64 tensor.
    """
    kmers: torch.Tensor
    out_mask: torch.Tensor
    in_mask: torch.Tensor
    num: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.kmers.shape[0]


def reverse4(mask: torch.Tensor) -> torch.Tensor:
    """Reverse a 4-bit nucleotide mask: bit c <-> bit 3-c (== complement)."""
    m = mask.to(torch.int64)
    out = ((m & 1) << 3) | ((m & 2) << 1) | ((m & 4) >> 1) | ((m & 8) >> 3)
    return out.to(mask.dtype)


def oriented_out_mask(vt: VertexTable, idx: torch.Tensor,
                      is_fwd: torch.Tensor) -> torch.Tensor:
    """Out-mask of vertex ``idx`` traversed with orientation ``is_fwd``.
    An absent vertex (idx == capacity) reads the last row, as JAX's
    clamped gather does."""
    idx = torch.clamp(idx, max=vt.capacity - 1)
    return torch.where(is_fwd, vt.out_mask[idx], reverse4(vt.in_mask[idx]))


def oriented_in_mask(vt: VertexTable, idx: torch.Tensor,
                     is_fwd: torch.Tensor) -> torch.Tensor:
    idx = torch.clamp(idx, max=vt.capacity - 1)
    return torch.where(is_fwd, vt.in_mask[idx], reverse4(vt.out_mask[idx]))


def popcount4(mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(torch.int64)
    return (m & 1) + ((m >> 1) & 1) + ((m >> 2) & 1) + ((m >> 3) & 1)


def kplus1_prefix_suffix(kp1: torch.Tensor, k: int):
    """Split packed (k+1)-mers (N, W1) into prefix/suffix k-mers.

    Returns (prefix (N, W), suffix (N, W), first_base (N,), last_base (N,)).
    """
    first = dna.kmer_first_base(kp1, k + 1)
    last = dna.kmer_last_base(kp1, k + 1)
    W = dna.words_per_kmer(k)
    keep = [min(max(k - dna.BASES_PER_WORD * w, 0), dna.BASES_PER_WORD)
            for w in range(W)]
    mask = torch.tensor(
        [(dna.WORD_MASK << (32 - 2 * kp)) & dna.WORD_MASK for kp in keep],
        dtype=torch.int64, device=kp1.device)
    # prefix = first k bases: original words masked to k bases
    prefix = kp1[..., :W] & mask
    # suffix = bases 1..k: 2-bit left shift with cross-word carry
    nxt = torch.cat([kp1[..., 1:],
                     torch.zeros(kp1.shape[:-1] + (1,), dtype=torch.int64,
                                 device=kp1.device)], dim=-1)
    shifted = ((kp1 << 2) & dna.WORD_MASK) | (nxt >> 30)
    suffix = shifted[..., :W] & mask
    return prefix, suffix, first, last


def build_vertex_table(kp1_table: KmerTable, k: int) -> VertexTable:
    """(k+1)-mer table -> canonical k-mer vertex table with masks: every
    unique (k+1)-mer ``s`` contributes out-base s[k] to its prefix k-mer
    and in-base s[0] to its suffix k-mer, redirected through
    canonicalisation."""
    E = kp1_table.capacity
    dev = kp1_table.kmers.device
    kp1_valid = torch.arange(E, device=dev) < kp1_table.num
    prefix, suffix, first, last = kplus1_prefix_suffix(kp1_table.kmers, k)

    cpre, pre_fwd = dna.canonicalize_kmers(prefix, k)
    csuf, suf_fwd = dna.canonicalize_kmers(suffix, k)

    all_k = torch.cat([cpre, csuf], dim=0)
    all_valid = torch.cat([kp1_valid, kp1_valid])
    uniq, _, num = segments.count_sorted(all_k, all_valid)

    pre_idx = segments.searchsorted_rows(uniq, cpre)
    suf_idx = segments.searchsorted_rows(uniq, csuf)
    N = uniq.shape[0]

    last = last.to(torch.int64)
    first = first.to(torch.int64)
    # prefix rule: canonical -> out bit last; else -> in bit comp(last)
    pre_col = torch.where(pre_fwd, last, 4 + (3 - last))
    # suffix rule: canonical -> in bit first; else -> out bit comp(first)
    suf_col = torch.where(suf_fwd, 4 + first, 3 - first)

    # (row, column) bits as flat indices into an (N + 1, 8) table whose
    # last row takes the dropped contributions
    bits = torch.zeros((N + 1) * 8, dtype=torch.uint8, device=dev)
    pre_row = torch.where(kp1_valid, pre_idx, N)
    suf_row = torch.where(kp1_valid, suf_idx, N)
    bits[pre_row * 8 + pre_col] = 1
    bits[suf_row * 8 + suf_col] = 1
    bits = bits.view(N + 1, 8)[:N].to(torch.int64)

    weights = 1 << torch.arange(4, device=dev)
    out_mask = (bits[:, :4] * weights).sum(1).to(torch.uint8)
    in_mask = (bits[:, 4:] * weights).sum(1).to(torch.uint8)
    return VertexTable(uniq, out_mask, in_mask, num)


def trim_vertex_table(vt: VertexTable) -> VertexTable:
    """Trim capacity to pow2(num); count_sorted keeps the all-ones
    padding sorted last, so the real rows are unchanged."""
    cap = 1 << max(1, int(vt.num) - 1).bit_length()
    cap = min(cap, vt.capacity)
    return VertexTable(vt.kmers[:cap], vt.out_mask[:cap],
                       vt.in_mask[:cap], vt.num)
