"""Sharded read mapping and paired-info fill over the mesh.

PyTorch counterpart of the JAX package's ``parallel/mapping_dist.py``
(the reference's read-processing fan-out, ``SequenceMapperNotifier``,
sequence_mapper_notifier.hpp:25-100: a loop over read chunks, buffers a
thread, a merge). Mapping is data-parallel: the reads split into
contiguous blocks, one a rank, the edge k-mer index is replicated (every
rank builds it from the same graph), and each rank maps its block with
the single-device chunked mapper. The paired-info "listener merge" is
every rank's (e1, e2, d) observation rows, gathered and counted in one
sort: the single-device fill's own count.
"""

from __future__ import annotations

import torch

from ..mapping import chunked, mapper
from ..paired import pair_info
from .mesh import Mesh, shard_reads


def map_reads_multi_sharded(mesh: Mesh, index, seq_len, conj,
                            codes, lengths, k: int,
                            max_placements: int = 4, min_votes: int = 2
                            ) -> mapper.ChainMapping:
    """Data-parallel ``map_reads_multi`` + ``normalize_chain``: every rank
    maps its block of the reads (``shard_reads``) against the replicated
    index; the blocks' chain mappings are gathered back in read order,
    so every rank returns the mapping of all R reads (on the mesh's
    device)."""
    codes = torch.as_tensor(codes)
    lengths = torch.as_tensor(lengths)
    c, ln, R = shard_reads(mesh, codes, lengths)
    ch = chunked.map_reads_multi_chunked(
        index, seq_len, c, ln, k, max_placements=max_placements,
        min_votes=min_votes, device=mesh.device)
    ch = mapper.normalize_chain(ch, conj)
    return mapper.ChainMapping(*(mesh.gather_cat(f)[:R] for f in ch))


def fill_paired_index_sharded(mesh: Mesh, ch1, ch2,
                              is_shift: int) -> pair_info.PairedIndex:
    """``fill_paired_index_multi_chunked`` with the read pairs split over
    the ranks: each rank takes the (e1, e2, d) rows of its block of
    pairs (``pair_info.pair_rows_chunked``), the rows of all ranks are
    gathered and counted in one sort on every rank. The sort makes the
    index independent of the rows' order, so it is the single-device
    fill's at any D: the same on every rank, on the mesh's device."""
    R = ch1.oriented_edge.shape[0]
    per = -(-R // mesh.size)
    lo, hi = mesh.rank * per, min((mesh.rank + 1) * per, R)

    def block(ch):
        return type(ch)(*(f[lo:hi] for f in ch))
    rows = torch.stack(pair_info.pair_rows_chunked(block(ch1), block(ch2),
                                                   is_shift), dim=1)
    return pair_info._count_rows(*mesh.gather_cat(rows).unbind(1))
