"""Distributed BayesHammer error correction over the mesh.

PyTorch counterpart of the JAX package's ``parallel/hammer_dist.py``
(the reference parallelises hammer with OpenMP in one node:
projects/hammer/main.cpp:64 counting, kmer_data.cpp KMerDataCounter's
locked Merge, expander.cpp's parallel read loop). The reads split into
contiguous blocks, one a rank; the k-mer table is replicated. The
loop is the single-device one (hammer/correct.py ``_correct_reads_bayes``,
its ``hammer_*`` scopes included) on the rank's block, with three steps
over the mesh:

1. **table and statistics**: each rank counts its block with the
   single-device chunked counter (``bayes.count_kmers_stats_chunked``:
   k-mers, counts, ``total_lq``, ``qual_sum``), the D tables are
   gathered and merged in rank order (``bayes._merge_stats_tables``,
   the collective form of kmer_data.cpp:119-155 Merge) into the same
   table on every rank;
2. **cluster and subcluster**: replicated, the same on every rank;
3. **expand**: each round's promotions are a per-rank read scan,
   OR-reduced over the ranks, until the global fixed point
   (expander.cpp:17-70);
4. **vote**: each rank corrects its own block; ``changed_bases`` is
   summed over the ranks, and the corrected blocks are gathered back in
   read order at the end.

Every rank returns the same corrected reads and stats. At D = 1 the
one table is the single-device table, bit for bit. At D >= 2 the float
statistics add each rank's partial sums, so ``total_lq`` and
``qual_sum`` may differ from the single-device sums in their last bits.
"""

from __future__ import annotations

import torch

from ..hammer import bayes
from ..hammer import correct as hcorrect
from ..kmers.counter import KmerTable
from ..ops import dna
from .mesh import Mesh, shard_reads


def _gather_stats_table(mesh: Mesh, table: KmerTable,
                        stats: bayes.KmerQualStats):
    """Every rank's (table, stats) merged in rank order into one table
    on every rank. The first rank's table is taken as it is, so at D = 1
    the result is the rank's own."""
    n = int(table.num)
    k = stats.qual_sum.shape[1]
    W = table.kmers.shape[1]
    ints = mesh.gather(torch.cat([table.kmers[:n],
                                  table.counts[:n, None].to(torch.int64)],
                                 dim=1))
    floats = mesh.gather(torch.cat([stats.total_lq[:n, None],
                                    stats.qual_sum[:n]], dim=1))
    merged = None
    for iv, fv in zip(ints, floats):
        m = iv.shape[0]
        cap = 1 << max(1, m - 1).bit_length()
        dev = iv.device
        kmers = torch.full((cap, W), dna.WORD_MASK, dtype=torch.int64,
                           device=dev)
        kmers[:m] = iv[:, :W]
        counts = torch.zeros(cap, dtype=torch.int32, device=dev)
        counts[:m] = iv[:, W].to(torch.int32)
        lq = torch.zeros(cap, dtype=torch.float32, device=dev)
        lq[:m] = fv[:, 0]
        qs = torch.zeros((cap, k), dtype=torch.float32, device=dev)
        qs[:m] = fv[:, 1:]
        part = (KmerTable(kmers, counts, torch.tensor(m, device=dev)),
                bayes.KmerQualStats(total_lq=lq, qual_sum=qs))
        merged = part if merged is None else bayes._trim_stats(
            *bayes._merge_stats_tables(*merged, *part))
    return merged


def make_sharded_hammer(mesh: Mesh, k: int, max_iterations: int = 2,
                        chunk_reads: int | None = None):
    """``correct(codes, lengths, quals) -> (codes, stats)``: the whole
    read batch in (every rank passes the same batch; each takes its
    block), the corrected batch out on the mesh's device, with the stats
    of hammer/correct.py ``_correct_reads_bayes``, whose loop runs on the
    rank's block with the mesh's merge of the tables, OR of the solid
    masks and sum of the changed bases. ``chunk_reads`` is the voting
    chunk, as ``correct_reads`` takes it."""
    def correct(codes, lengths, quals):
        codes = torch.as_tensor(codes)
        lengths = torch.as_tensor(lengths)
        c, ln, R = shard_reads(mesh, codes, lengths)
        q, _, _ = shard_reads(mesh, torch.as_tensor(quals), lengths)
        chunk = chunk_reads
        if chunk is None:
            chunk = hcorrect.vote_chunk_reads(c.shape[1], k, c.device)
        fixed, stats = hcorrect._correct_reads_bayes(
            c, ln, q, k, max_iterations, chunk,
            merge_table=lambda t, st: _gather_stats_table(mesh, t, st),
            reduce_solid=lambda m: mesh.max(m.to(torch.int32)) > 0,
            sum_changed=lambda n: int(mesh.sum(
                torch.tensor([n], dtype=torch.int64))))
        return mesh.gather_cat(fixed)[:R], stats
    return correct
