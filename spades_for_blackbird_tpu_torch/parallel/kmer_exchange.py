"""Sharded k-mer counting: hash-partitioned exchange over the mesh.

PyTorch counterpart of the JAX package's ``parallel/kmer_exchange.py``
(the reference's hash-segment disk buckets, kmer_index_builder.hpp:220-366
+ kmer_buckets.hpp:15-44): each rank counts its read shard, routes the
counted rows to their owner rank by k-mer hash, and each owner merges
what it received into its partition. The result is a globally
partitioned sorted k-mer table: rank i holds exactly the k-mers with
``kmer_hash(words) % D == i``.

The JAX package extracts a shard's windows in one piece and sends every
window, in a buffer of a capacity factor times the stream. The port
counts its shard with the chunked counter (``counter.count_kmers_chunked``,
the single-device path's, so a rank's memory stays that of a counting
chunk) and sends the unique rows with their counts, with exact split
sizes (``Mesh.exchange``): counts are integers, so the owner's merge
gives every k-mer the same count as the one-piece count, and nothing is
ever dropped. The JAX package raises on a hash imbalance past its
capacity factor; the port runs on there.
"""

from __future__ import annotations

import torch

from ..kmers import counter
from ..kmers.counter import KmerTable
from ..kmers.hll import kmer_hash
from ..ops import dna, segments
from .mesh import Mesh


def owner_of(mesh: Mesh, words: torch.Tensor) -> torch.Tensor:
    """The rank that owns each k-mer row (..., W): hash mod D."""
    return kmer_hash(words) % mesh.size


def _real_rows(t: KmerTable) -> tuple[torch.Tensor, torch.Tensor]:
    n = int(t.num)
    return t.kmers[:n], t.counts[:n]


def pow2_table(kmers: torch.Tensor, counts: torch.Tensor) -> KmerTable:
    """A table of these real rows (sorted), padded to the power of two
    at or above their number, as ``counter.trim_table`` cuts a longer
    one."""
    num = kmers.shape[0]
    cap = 1 << max(1, num - 1).bit_length()
    out_k = torch.full((cap, kmers.shape[1]), dna.WORD_MASK,
                       dtype=torch.int64, device=kmers.device)
    out_c = torch.zeros(cap, dtype=torch.int32, device=kmers.device)
    out_k[:num] = kmers
    out_c[:num] = counts.to(torch.int32)
    return KmerTable(out_k, out_c, torch.tensor(num, device=kmers.device))


def route_table(mesh: Mesh, t: KmerTable) -> KmerTable:
    """Send a counted table's rows to their owners; each owner merges the
    rows it received, counts adding (``segments.count_sorted``). Returns
    this rank's partition (``pow2_table``)."""
    kmers, counts = _real_rows(t)
    W = t.kmers.shape[1]
    rows = torch.cat([kmers, counts.to(torch.int64)[:, None]], dim=1)
    got, _ = mesh.exchange(rows, owner_of(mesh, kmers))
    if got.shape[0] == 0:
        return pow2_table(got[:, :W], got[:, W])
    valid = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
    uniq, cnt, num = segments.count_sorted(got[:, :W], valid,
                                           got[:, W].to(torch.int32))
    n = int(num)
    return pow2_table(uniq[:n], cnt[:n])


def make_sharded_counter(mesh: Mesh, k: int):
    """``count(codes, lengths) -> KmerTable``: this rank's read shard
    (``mesh.shard_reads``) in, this rank's hash partition of the
    canonical k-mer table of all ranks' reads out (sorted, padded to a
    power of two, as ``counter.trim_table`` leaves it)."""
    def count(codes: torch.Tensor, lengths: torch.Tensor) -> KmerTable:
        local = counter.trim_table(
            counter.count_kmers_chunked(codes, lengths, k))
        return route_table(mesh, local)
    return count


def make_sharded_table_merge(mesh: Mesh):
    """``merge(a, b) -> KmerTable``: the rank-local merge of two tables
    partitioned by the same hash (counts add), trimmed; used to fold the
    extra sequences' k-mers into the read table."""
    def merge(a: KmerTable, b: KmerTable) -> KmerTable:
        return counter.trim_table(counter.merge_tables(a, b))
    return merge


def make_sharded_min_count_filter(mesh: Mesh):
    """``filt(table, min_count) -> KmerTable``: ``counter.filter_min_count``
    on this rank's partition, which keeps its hash partition and its
    sorted-with-padding-last order, trimmed."""
    def filt(t: KmerTable, min_count: int) -> KmerTable:
        return counter.trim_table(counter.filter_min_count(t, min_count))
    return filt


def gather_table(mesh: Mesh, t: KmerTable) -> KmerTable:
    """Every rank's partition merged into one sorted table on every rank
    (the partitions are disjoint, so the merge is a sort)."""
    kmers, counts = _real_rows(t)
    W = t.kmers.shape[1]
    rows = mesh.gather_cat(torch.cat(
        [kmers, counts.to(torch.int64)[:, None]], dim=1))
    perm = segments.lexsort_perm(segments.fuse_words(rows[:, :W]))
    return pow2_table(rows[perm, :W], rows[perm, W])

