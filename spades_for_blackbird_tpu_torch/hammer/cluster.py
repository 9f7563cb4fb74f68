"""Hamming-space k-mer clustering for read error correction.

PyTorch counterpart of the JAX package's ``hammer/cluster.py``
(projects/hammer/hamcluster.cpp ``KMerHamClusterer`` + the center election
of kmer_cluster.cpp):

- distance-1 neighbours by *masked-variant sorting*: one wildcard position
  a pass, the k-mers' sort keys with that position's two bits cleared are
  sorted, and equal keys are neighbours (the reference's sub-k-mer sorts,
  hamcluster.cpp:140);
- union-find by min-label propagation over the equal-key runs with path
  compression, ``n_rounds * k`` passes (the JAX ``fori_loop``, here a
  Python loop);
- center election per cluster: the dominant-count k-mer.

The passes work on the table's fused sort keys (``segments.fused_cols``):
clearing a base of a word clears two bits of its key, so a pass masks one
key column instead of copying the (N, W) words. Rows past ``num`` are
padding and never join a cluster; the passes run on the first ``num``
rows only, which gives the JAX package's labels for every real row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import dna, segments

_SIGN = -(1 << 63)


class HammerClusters(NamedTuple):
    rep: torch.Tensor        # (N,) int64 cluster representative per kmer
    is_center: torch.Tensor  # (N,) bool: kmer is its cluster's center
    solid: torch.Tensor      # (N,) bool: kmer considered genomic ("good")
    center_of: torch.Tensor  # (N,) int64 row of the cluster's center


def _clear_base(raw: list[torch.Tensor], n_words: int, pos: int
                ) -> list[torch.Tensor]:
    """Sort keys of the k-mers with base ``pos`` cleared to A. ``raw``
    holds the key columns with the sign flip of ``fused_cols`` undone,
    so that a pair column is the bit pattern (hi << 32) | lo."""
    word, slot = divmod(pos, dna.BASES_PER_WORD)
    g = word // 2
    lone = 2 * g + 1 >= n_words     # a last word without a partner
    shift = (dna.BASES_PER_WORD - 1 - slot) * 2
    if not lone and word % 2 == 0:
        shift += 32
    mask = ~(3 << shift) & ((1 << 64) - 1)
    if mask >= 1 << 63:             # as a signed int64
        mask -= 1 << 64
    out = []
    for i, col in enumerate(raw):
        key = col & mask if i == g else col
        out.append(key if 2 * i + 1 >= n_words else key ^ _SIGN)
    return out


def cluster_kmers(kmers: torch.Tensor, counts: torch.Tensor,
                  num: torch.Tensor, k: int, good_threshold,
                  center_ratio, n_rounds: int = 2) -> HammerClusters:
    """Cluster unique k-mers (N, W) by Hamming-distance-1 connectivity.

    Args:
      kmers/counts/num: unique k-mer table (padded ragged).
      good_threshold: counts >= this are solid regardless of clustering.
      center_ratio: a member is an error of its center when
        count * center_ratio <= center_count (float32, as in the JAX
        package).
    """
    N, W = kmers.shape
    dev = kmers.device
    n = int(num)
    fused = segments.fuse_words(kmers[:n])
    raw = [c if 2 * i + 1 >= W else c ^ _SIGN for i, c in enumerate(fused)]
    rep = torch.arange(n, device=dev)
    for i in range(n_rounds * k):
        keys = _clear_base(raw, W, i % k)
        perm = segments.lexsort_perm(keys)
        differs = torch.zeros(n, dtype=torch.bool, device=dev)
        for c in keys:
            sc = c[perm]
            differs[1:] |= sc[1:] != sc[:-1]
        differs[:1] = True
        gid = torch.cumsum(differs, 0) - 1
        gmin = segments.drop_scatter(n, gid, rep[perm], "amin", init=n)
        upd = torch.empty_like(rep)
        upd[perm] = gmin[gid]
        rep = torch.minimum(rep, upd)
        # path-compress: follow rep once
        rep = torch.minimum(rep, rep[rep])

    # center election: max count per cluster, ties to the smallest row
    cnt = counts[:n]
    cmax = segments.drop_scatter(n, rep, cnt, "amax", init=0)
    center_count = cmax[rep]
    is_cand = cnt == center_count
    rows = torch.arange(n, device=dev)
    cidx = segments.drop_scatter(n, torch.where(is_cand, rep, n), rows,
                                 "amin", init=n)
    is_center = is_cand & (rows == cidx[rep])
    solid = (is_center | (cnt >= good_threshold)
             | (cnt.to(torch.float32) * torch.tensor(
                 center_ratio, dtype=torch.float32, device=dev)
                > center_count.to(torch.float32)))

    def padded(x, fill):
        out = torch.full((N,), fill, dtype=x.dtype, device=dev)
        out[:n] = x
        return out
    return HammerClusters(rep=padded(rep, N),
                          is_center=padded(is_center, False),
                          solid=padded(solid, False),
                          center_of=padded(cidx[rep], N))
