"""Canonical k-mer counting: reads -> sorted unique (k-mer, count) table.

PyTorch counterpart of the JAX package's ``kmers/counter.py``:
extract and canonicalise (the CUDA kernel on the card,
``ops/kmer_cuda.py``), sort, run-length reduce.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import chunking, dna, kmer_cuda, segments
from ..utils import membudget

# reads per counting chunk when the reads lie on the CPU
CPU_CHUNK_READS = 1 << 20


class KmerTable(NamedTuple):
    """Sorted unique canonical k-mers with counts (padded ragged).

    kmers: (N, W) int64 words, lexicographically sorted; rows >= num are
      all-ones padding.
    counts: (N,) int32.
    num: 0-dim int64 tensor, the number of real rows.
    """
    kmers: torch.Tensor
    counts: torch.Tensor
    num: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.kmers.shape[0]


def count_kmers(codes: torch.Tensor, lengths: torch.Tensor, k: int
                ) -> KmerTable:
    """Count canonical k-mers of a read batch (one chunk).

    The extraction writes the sort's keys (fused word pairs, invalid
    windows as the sentinel where k % 16 != 0), so they go to the sort
    as they are; only the counted rows are turned back into words.
    """
    keys, valid = kmer_cuda.extract_sort_keys(
        codes.contiguous(), lengths.to(torch.int32).contiguous(), k)
    uniq, counts, num = segments.count_sorted_keys(
        list(keys.unbind(0)), dna.words_per_kmer(k), valid)
    return KmerTable(uniq, counts, num)


def count_kmers_quality(codes: torch.Tensor, lengths: torch.Tensor,
                        quals: torch.Tensor, k: int):
    """Count canonical k-mers with per-k-mer quality mass.

    The BayesHammer counting statistic (projects/hammer kmer_stat.hpp:
    each k-mer instance carries its bases' error probabilities): a
    k-mer's quality weight is the product over its bases of
    (1 - 10^(-phred/10)), summed over instances, in float32 as in the
    JAX package. ``quals`` are raw phred+33 bytes shaped like ``codes``.

    Returns (KmerTable with integer counts, qweight (N,) float32), N the
    number of windows.
    """
    R, L = codes.shape
    P = L - k + 1
    keys, valid = kmer_cuda.extract_sort_keys(
        codes.contiguous(), lengths.to(torch.int32).contiguous(), k)
    q = torch.clamp(quals.to(torch.float32) - 33.0, min=0.0)
    perr = torch.clamp(torch.pow(10.0, -q / 10.0), max=0.75)
    cs0 = torch.nn.functional.pad(torch.cumsum(torch.log1p(-perr), 1),
                                  (1, 0))
    w = torch.exp(cs0[:, k:P + k] - cs0[:, :P])          # (R, P)
    uniq, counts, num, perm, gid = segments.group_sorted_keys(
        list(keys.unbind(0)), dna.words_per_kmer(k), valid)
    qweight = segments.drop_scatter(R * P, gid, w.reshape(-1)[perm])
    return KmerTable(uniq, counts, num), qweight


def filter_min_count(table: KmerTable, min_count: int) -> KmerTable:
    """Drop k-mers with count < min_count (keeps sort order)."""
    rows = torch.arange(table.capacity, device=table.kmers.device)
    keep = (table.counts >= min_count) & (rows < table.num)
    num, (kmers, counts) = segments.compact(keep, table.kmers, table.counts)
    # compact() zero-fills; restore all-ones padding so the table stays
    # sorted-with-padding-last for binary search
    kmers = torch.where((rows >= num)[:, None], dna.WORD_MASK, kmers)
    return KmerTable(kmers, counts, num)


def trim_table(t: KmerTable) -> KmerTable:
    """Cut capacity to the power of two at or above ``num`` (never
    above the current capacity); rows past ``num`` are padding. A cut
    table is a copy, so that the longer one's memory is released: a
    counted chunk has one row a window before it is trimmed."""
    cap = 1 << max(1, int(t.num) - 1).bit_length()
    if cap >= t.capacity:
        return t
    return KmerTable(t.kmers[:cap].clone(), t.counts[:cap].clone(), t.num)


def chunk_reads_for(read_len: int, k: int, device: torch.device) -> int:
    """Reads per counting chunk.

    On the card the chunk is sized from the free device memory: a
    quarter of it over the bytes a read's windows hold at the peak of
    ``count_kmers``, rounded down to a power of two. That peak is the
    end of ``segments.count_sorted_keys``, where the table is unfused:
    the kernel's G = ceil(W/2) int64 keys, the G run-length encoded
    keys, the W int64 words of the table, and the counts, the validity
    and one key's temporaries beside them, 16*G + 8*W + 32 bytes a
    window (``chip_smoke.py`` reads 60 to 157 bytes a window at W = 2 to
    8 on an H100, each within 4 bytes under this). On the CPU it is
    ``CPU_CHUNK_READS``.
    """
    words = dna.words_per_kmer(k)
    per_read = max(read_len - k + 1, 1) * (16 * ((words + 1) // 2)
                                           + 8 * words + 32)
    return membudget.reads_per_chunk(per_read, device, CPU_CHUNK_READS)


def count_kmers_chunked(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                        chunk_reads: int | None = None) -> KmerTable:
    """Count k-mers of a batch too large for one sort: each read chunk is
    counted, and the sorted unique tables merge pairwise."""
    if chunk_reads is None:
        chunk_reads = chunk_reads_for(codes.shape[1], k, codes.device)
    R = codes.shape[0]
    if R <= chunk_reads:
        return count_kmers(codes, lengths, k)
    codes_p = chunking.pad_to_multiple(codes, chunk_reads,
                                       fill=dna.INVALID_CODE)
    lengths_p = chunking.pad_to_multiple(lengths, chunk_reads)
    table = None
    for lo in range(0, R, chunk_reads):
        c = chunking.dslice(codes_p, lo, chunk_reads)
        l = chunking.dslice(lengths_p, lo, chunk_reads)
        part = trim_table(count_kmers(c, l, k))
        table = part if table is None else trim_table(
            merge_tables(table, part))
    return table


def merge_tables(a: KmerTable, b: KmerTable) -> KmerTable:
    """Merge two counted tables (counts add). Capacity = sum of inputs."""
    dev = a.kmers.device
    kmers = torch.cat([a.kmers, b.kmers], dim=0)
    weights = torch.cat([a.counts, b.counts])
    valid = torch.cat([torch.arange(a.capacity, device=dev) < a.num,
                       torch.arange(b.capacity, device=dev) < b.num])
    uniq, counts, num = segments.count_sorted(kmers, valid, weights)
    return KmerTable(uniq, counts.to(torch.int32), num)


def lookup_windows(hay: list[torch.Tensor], num: torch.Tensor,
                   codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """The table row of every k-window of a read batch, through the
    extraction kernel's strand entry: ``hay`` is the table's fused keys
    (``segments.fuse_words(table.kmers)``, fused once by the caller).
    Returns (found (R, P) bool, row (R, P) int64, 0 where not found,
    is_fwd (R, P) bool)."""
    R, L = codes.shape
    keys, valid, is_fwd = kmer_cuda.extract_canonical_keys(
        codes.contiguous(), lengths.to(torch.int32).contiguous(), k)
    row = segments.search_keys(hay, list(keys.unbind(0))).view(R, L - k + 1)
    found = row < num
    if valid is not None:
        found &= valid.view(R, -1)
    return found, torch.where(found, row, 0), is_fwd.view(R, -1)


def lookup(table: KmerTable, queries: torch.Tensor):
    """Find query k-mers (M, W) in the table.

    Returns (idx (M,) into table rows, found (M,) bool).
    """
    idx = segments.searchsorted_rows(table.kmers, queries)
    found = idx < table.num
    return torch.where(found, idx, 0), found
