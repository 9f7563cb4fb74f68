"""BayesHammer's statistical core: quality statistics, Bayesian
subclustering and the solid-set expander.

PyTorch counterpart of the JAX package's ``hammer/bayes.py``
(projects/hammer kmer_stat.hpp KMerStat, kmer_cluster.cpp
lMeansClustering/SubClusterSingle/ProcessCluster, expander.cpp):

- per-k-mer quality statistics: ``total_lq``, the sum over instances of
  log P(instance erroneous), and ``qual_sum``, the per-position phred sum
  in canonical orientation capped at 63; both float32 scatter-adds, as in
  the JAX package (x64 off: ``1.0 - 1e-12`` is 1.0 there and here);
- Bayesian l-means subclustering of each Hamming cluster, every cluster's
  EM at once as one (N, max_l, k) masked tensor program, BIC model
  selection, good/bad marking of the subcluster centers;
- iterative solid-set expansion over reads.

Windows come from the CUDA extraction kernel's strand entry
(``kmer_cuda.extract_canonical_keys``): sort keys, validity and the strand
of every window. The table's rows are searched by key
(``counter.lookup_windows``) with the table fused once a pass.

Float sums: ``logl`` adds its k terms left to right, as XLA does on the
CPU, so that the same probabilities give the same sums on every device;
the probabilities come from a table of the 64 values ``qual_sum`` can take
(phred sums are integers), made on the host. The scatter-adds of
``total_lq`` and the BIC ``loglik`` take their terms in another order on
the card (atomics) than on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kmers import counter
from ..ops import dna, kmer_cuda, segments
from ..utils import membudget

# reference defaults (configs/hammer/config.info:29-56)
SINGLETON_THRESHOLD = 0.995     # bayes_singleton_threshold
NONSINGLETON_THRESHOLD = 0.9    # bayes_nonsingleton_threshold
CORRECT_THRESHOLD = 0.98        # correct_threshold (correct_use_threshold=1)
QUAL_CAP = 63                   # QualBitSet 6-bit nibble saturation
# rows of one subclustering chunk: a cluster larger than this is cut at
# the chunk's edge, so the size is part of the result (JAX package's value)
SUBCLUSTER_CHUNK = 1 << 18
# reads a chunk on the CPU, where the card's free memory does not size it
CPU_STATS_CHUNK_READS = 1 << 15
CPU_DEVICE_CAP_ROWS = 1 << 24
CPU_EXPAND_CHUNK_READS = 1 << 18
# float32 rounds 1 - 1e-12 to 1.0: an instance whose error probability
# rounds to 0 gets log P(erroneous) = -inf, as in the JAX package
_ALMOST_ONE = float(np.float32(1.0 - 1e-12))


class KmerQualStats(NamedTuple):
    total_lq: torch.Tensor    # (N,) float32: sum of log per-instance err prob
    qual_sum: torch.Tensor    # (N, k) float32: per-position phred sum (cap 63)


class SubClusters(NamedTuple):
    solid: torch.Tensor         # (N,) bool: k-mer marked good
    is_center: torch.Tensor     # (N,) bool: k-mer is a subcluster center
    center_bases: torch.Tensor  # (N, k) uint8: consensus bases of the
    #                             k-mer's subcluster (its voting target)
    rep: torch.Tensor           # (N,) int64 Hamming-cluster representative


def stats_chunk_reads(read_len: int, k: int, device: torch.device) -> int:
    """Reads a quality-statistics chunk holds: on the card from its free
    memory, at 64 + 16k bytes a window (the sort's keys, permutation and
    runs, the (windows, k) float32 qualities oriented and gathered) and
    24 a base; ``CPU_STATS_CHUNK_READS`` on the CPU. The chunk changes
    only the order of the float sums."""
    per_read = (max(read_len - k + 1, 1) * (64 + 16 * k)
                + 24 * max(read_len, 1))
    return membudget.reads_per_chunk(per_read, device, CPU_STATS_CHUNK_READS)


def table_cap_rows(k: int, device: torch.device) -> int:
    """Unique-table rows past which the statistics take the spill path:
    half the card's free memory over a row of the (U, k) float32
    accumulator, its table row and count (``CPU_DEVICE_CAP_ROWS`` on the
    CPU)."""
    per_row = 4 * k + 8 * dna.words_per_kmer(k) + 8
    return membudget.reads_per_chunk(per_row, device, CPU_DEVICE_CAP_ROWS,
                                     share=2, most=1 << 30)


def _phred_table(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """log P(correct) and log P(this wrong base) of phred values 0..n-1
    (main.cpp:103-108: rprob = 0.75 below q=3, else 10^(-q/10)), float32,
    computed on the host so that every device reads the same values."""
    q = torch.arange(n, dtype=torch.float32)
    perr = torch.where(q < 3.0, torch.tensor(0.75),
                       torch.pow(10.0, -q / 10.0))
    lp = torch.log1p(-perr)
    lrp = torch.log(perr) - torch.log(torch.tensor(3.0))
    return lp.to(device), lrp.to(device)


def _qual_probs(qual_sum: torch.Tensor):
    """Per-position log-probabilities from summed phred quality."""
    lp, lrp = _phred_table(QUAL_CAP + 1, qual_sum.device)
    q = torch.clamp(qual_sum, max=float(QUAL_CAP)).to(torch.int64)
    return lp[q], lrp[q]


def _phred(quals: torch.Tensor) -> torch.Tensor:
    """Raw phred+33 bytes -> phred values, float32."""
    return torch.clamp(quals.to(torch.float32) - 33.0, min=0.0)


def _instance_lq(quals: torch.Tensor, k: int) -> torch.Tensor:
    """(R, L) phred+33 -> (R, P) log(1 - prod P(base correct)) of every
    window (kmer_data.cpp:119-155)."""
    R, L = quals.shape
    P = L - k + 1
    lp, _ = _phred_table(256, quals.device)
    cs0 = torch.nn.functional.pad(
        torch.cumsum(lp[torch.clamp(quals.to(torch.int64) - 33, min=0)], 1),
        (1, 0))
    lp_inst = cs0[:, k:P + k] - cs0[:, :P]
    return torch.log1p(-torch.clamp(torch.exp(lp_inst), max=_ALMOST_ONE))


def _oriented_quals(q: torch.Tensor, is_fwd: torch.Tensor, k: int
                    ) -> torch.Tensor:
    """(R, L) phred, (R, P) or (R*P,) strand -> (R*P, k) phred of every
    window in canonical orientation (PushKMerRC reverses the quality
    vector, kmer_data.cpp:138-143)."""
    win = q.unfold(1, k, 1)                              # (R, P, k) view
    fwd = is_fwd.view(win.shape[0], win.shape[1], 1)
    return torch.where(fwd, win, win.flip(-1)).reshape(-1, k)


def count_kmers_stats(codes: torch.Tensor, lengths: torch.Tensor,
                      quals: torch.Tensor, k: int
                      ) -> tuple[counter.KmerTable, KmerQualStats]:
    """Count canonical k-mers with BayesHammer's quality statistics
    (KMerDataCounter's Merge, kmer_data.cpp:119-155). The table's
    capacity is the number of windows, as in the JAX package."""
    keys, valid, is_fwd = kmer_cuda.extract_canonical_keys(
        codes.contiguous(), lengths.to(torch.int32).contiguous(), k)
    NR = keys.shape[1]
    uniq, counts, num, perm, gid = segments.group_sorted_keys(
        list(keys.unbind(0)), dna.words_per_kmer(k), valid)
    del keys
    total_lq = segments.drop_scatter(
        NR, gid, _instance_lq(quals, k).reshape(-1)[perm])
    qv = _oriented_quals(_phred(quals), is_fwd, k)[perm]
    qual_sum = torch.zeros((NR + 1, k), dtype=torch.float32,
                           device=codes.device)
    segments.index_add_float(qual_sum, gid, qv, limit=NR)
    qual_sum = torch.clamp(qual_sum[:NR], max=float(QUAL_CAP))
    return (counter.KmerTable(uniq, counts, num),
            KmerQualStats(total_lq=total_lq, qual_sum=qual_sum))


def _trim_stats(table: counter.KmerTable, stats: KmerQualStats):
    """Trim table+stats to the pow2 capacity ``counter.trim_table`` gives
    (a copy, so that the longer one's memory is released)."""
    t = counter.trim_table(table)
    if t is table:
        return table, stats
    cap = t.capacity
    return t, KmerQualStats(total_lq=stats.total_lq[:cap].clone(),
                            qual_sum=stats.qual_sum[:cap].clone())


def _merge_stats_tables(a: counter.KmerTable, sa: KmerQualStats,
                        b: counter.KmerTable, sb: KmerQualStats):
    """Merge two sorted unique k-mer tables with quality statistics:
    counts, total_lq and per-position qual_sum add per identical k-mer
    (the streamed equivalent of kmer_data.cpp:119 Merge)."""
    dev = a.kmers.device
    W = a.kmers.shape[1]
    valid = torch.cat([torch.arange(a.capacity, device=dev) < a.num,
                       torch.arange(b.capacity, device=dev) < b.num])
    uniq, _, num, perm, gid = segments.group_sorted_keys(
        segments.fuse_words(torch.cat([a.kmers, b.kmers])), W, valid)
    N = perm.shape[0]
    counts = segments.drop_scatter(N, gid,
                                   torch.cat([a.counts, b.counts])[perm])
    lq = segments.drop_scatter(
        N, gid, torch.cat([sa.total_lq, sb.total_lq])[perm])
    qs = torch.zeros((N + 1, sa.qual_sum.shape[1]), dtype=torch.float32,
                     device=dev)
    segments.index_add_float(
        qs, gid, torch.cat([sa.qual_sum, sb.qual_sum])[perm], limit=N)
    qs = torch.clamp(qs[:N], max=float(QUAL_CAP))
    return (counter.KmerTable(uniq, counts, num),
            KmerQualStats(total_lq=lq, qual_sum=qs))


def _spill_to_host(table: counter.KmerTable, stats: KmerQualStats):
    n = int(table.num)
    return (table.kmers[:n].cpu().numpy(), table.counts[:n].cpu().numpy(),
            stats.total_lq[:n].cpu().numpy(),
            stats.qual_sum[:n].cpu().numpy())


def _merge_spills_host(spills, k: int, device):
    """Merge host-side spilled chunk tables: one lexsort over the
    concatenated keys + segment reduceat of the statistics (the HBM
    analogue of the reference's disk-bucket merge,
    kmer_index_builder.hpp:281-338), then back onto ``device``."""
    kk = np.concatenate([s[0] for s in spills], axis=0)
    cc = np.concatenate([s[1] for s in spills])
    lq = np.concatenate([s[2] for s in spills])
    qs = np.concatenate([s[3] for s in spills], axis=0)
    order = np.lexsort(tuple(kk[:, w] for w in range(kk.shape[1] - 1,
                                                     -1, -1)))
    kk, cc, lq, qs = kk[order], cc[order], lq[order], qs[order]
    new = np.empty(kk.shape[0], bool)
    new[0] = True
    np.any(kk[1:] != kk[:-1], axis=1, out=new[1:])
    starts = np.nonzero(new)[0]
    uniq = kk[starts]
    counts = np.add.reduceat(cc.astype(np.int64), starts).astype(np.int32)
    mlq = np.add.reduceat(lq.astype(np.float64), starts).astype(np.float32)
    mqs = np.minimum(np.add.reduceat(qs.astype(np.float64), starts,
                                     axis=0),
                     float(QUAL_CAP)).astype(np.float32)
    num = uniq.shape[0]
    pad = (1 << max(1, num - 1).bit_length()) - num

    def put(a, fill=0):
        widths = ((0, pad),) + ((0, 0),) * (a.ndim - 1)
        return torch.from_numpy(np.pad(a, widths, constant_values=fill)
                                ).to(device)
    table = counter.KmerTable(put(uniq, dna.WORD_MASK), put(counts),
                              torch.tensor(num, device=device))
    return table, KmerQualStats(total_lq=put(mlq), qual_sum=put(mqs))


def _accum_stats(hay: list[torch.Tensor], num: torch.Tensor,
                 codes: torch.Tensor, lengths: torch.Tensor,
                 quals: torch.Tensor, total_lq: torch.Tensor,
                 qual_sum: torch.Tensor, k: int) -> None:
    """Scatter one read chunk's quality statistics into the final-table
    accumulators, in place: extraction, a search of the table's fused
    keys ``hay``, two scatter-adds. Row ``len(total_lq) - 1`` takes what
    is not in the table."""
    found, row, is_fwd = counter.lookup_windows(hay, num, codes, lengths, k)
    sidx = torch.where(found, row, total_lq.shape[0] - 1).reshape(-1)
    del found, row
    drop = total_lq.shape[0] - 1
    segments.index_add_float(total_lq, sidx,
                             _instance_lq(quals, k).reshape(-1), limit=drop)
    segments.index_add_float(qual_sum, sidx,
                             _oriented_quals(_phred(quals), is_fwd, k),
                             limit=drop)


def count_kmers_stats_chunked(codes, lengths, quals, k: int,
                              chunk: int | None = None,
                              device_cap_rows: int | None = None
                              ) -> tuple[counter.KmerTable, KmerQualStats]:
    """``count_kmers_stats`` for libraries too large for one sort, as
    two passes (kmer_data.cpp KMerDataCounter builds the index, then
    fills per-k-mer statistics):

    1. key-only chunked counting (``counter.count_kmers_chunked``) builds
       the final sorted unique table;
    2. each read chunk's windows find their table row and scatter-add
       ``total_lq`` / ``qual_sum`` into accumulators of the final size.

    Past ``device_cap_rows`` table rows the merge/spill path runs
    instead. ``chunk`` and ``device_cap_rows`` default to sizes from the
    card's free memory (``stats_chunk_reads``, ``table_cap_rows``);
    given, they win.
    """
    if chunk is None:
        chunk = stats_chunk_reads(codes.shape[1], k, codes.device)
    if device_cap_rows is None:
        device_cap_rows = table_cap_rows(k, codes.device)
    R = codes.shape[0]
    if R <= chunk:
        return _trim_stats(*count_kmers_stats(codes, lengths, quals, k))
    table = counter.trim_table(
        counter.count_kmers_chunked(codes, lengths, k))
    if table.capacity > device_cap_rows:
        return _count_kmers_stats_chunked_spill(
            codes, lengths, quals, k, chunk, device_cap_rows)
    U = table.capacity
    total_lq = torch.zeros(U + 1, dtype=torch.float32, device=codes.device)
    qual_sum = torch.zeros((U + 1, k), dtype=torch.float32,
                           device=codes.device)
    hay = segments.fuse_words(table.kmers)
    for lo in range(0, R, chunk):
        _accum_stats(hay, table.num, codes[lo:lo + chunk],
                     lengths[lo:lo + chunk], quals[lo:lo + chunk],
                     total_lq, qual_sum, k)
    return table, KmerQualStats(
        total_lq=total_lq[:U],
        qual_sum=torch.clamp(qual_sum[:U], max=float(QUAL_CAP)))


def _count_kmers_stats_chunked_spill(codes, lengths, quals, k: int,
                                     chunk: int, device_cap_rows: int
                                     ) -> tuple[counter.KmerTable,
                                                KmerQualStats]:
    """Merge/spill path for tables beyond the card's capacity: chunk
    tables merge on the device while they fit ``device_cap_rows``, and
    spill to the host past it."""
    table = stats = None
    spills = []
    for lo in range(0, codes.shape[0], chunk):
        t, s = _trim_stats(*count_kmers_stats(
            codes[lo:lo + chunk], lengths[lo:lo + chunk],
            quals[lo:lo + chunk], k))
        if table is None:
            table, stats = t, s
        elif table.capacity + t.capacity > device_cap_rows:
            spills.append(_spill_to_host(table, stats))
            table, stats = t, s
        else:
            table, stats = _trim_stats(
                *_merge_stats_tables(table, stats, t, s))
    if spills:
        spills.append(_spill_to_host(table, stats))
        table, stats = _merge_spills_host(spills, k, codes.device)
    return table, stats


def _logl(centers: torch.Tensor, bases: torch.Tensor, lp: torch.Tensor,
          lrp: torch.Tensor) -> torch.Tensor:
    """(N, max_l, k) center bases against each row's bases -> (N, max_l)
    quality log-likelihood (ExpandedKMer::logL, kmer_stat.hpp:218), the
    k terms added left to right."""
    match = centers == bases[:, None, :]
    terms = torch.where(match, lp[:, None, :], lrp[:, None, :])
    out = terms[..., 0].clone()
    for j in range(1, terms.shape[-1]):
        out += terms[..., j]
    return out


def subcluster_kmers(kmers: torch.Tensor, counts: torch.Tensor,
                     num: torch.Tensor, stats: KmerQualStats,
                     rep: torch.Tensor, k: int, max_l: int = 4,
                     em_iters: int = 4) -> SubClusters:
    """Bayesian subclustering of Hamming clusters (kmer_cluster.cpp).

    ``rep`` assigns each unique k-mer to its Hamming cluster (from
    ``cluster.cluster_kmers``). For every cluster, l-means with a
    quality-aware likelihood runs for l = 1..max_l; BIC selects the best
    l; subcluster centers are quality-marked good/bad.
    """
    N, W = kmers.shape
    dev = kmers.device
    rows = torch.arange(N, device=dev)
    valid = rows < num
    bases = dna.unpack_kmers(kmers, k).to(torch.int64)     # (N, k)
    lp, lrp = _qual_probs(stats.qual_sum)                  # (N, k)

    # dense cluster ids + count-descending rank within cluster
    # (clusters sorted in count-decreasing order, kmer_cluster.cpp:624)
    repk = torch.where(valid, rep, N)
    order = segments.lexsort_perm([repk, -counts.to(torch.int64)])
    srep = repk[order]
    start = torch.ones(N, dtype=torch.bool, device=dev)
    start[1:] = srep[1:] != srep[:-1]
    cid_sorted = torch.cumsum(start, 0) - 1
    seg_first = torch.cummax(torch.where(start, rows, 0), 0).values
    cid = torch.empty_like(cid_sorted)
    cid[order] = cid_sorted
    rank = torch.empty_like(cid_sorted)
    rank[order] = rows - seg_first
    csize = segments.drop_scatter(
        N, torch.where(valid[order], cid_sorted, N),
        torch.ones(N, dtype=torch.int64, device=dev))
    vcid = torch.where(valid, cid, N)

    # candidate seed rows: top-max_l members by count (lMeansClustering
    # "we assume that kmers are sorted wrt the count", :154-156)
    cand = torch.full((N * max_l + 1,), N, dtype=torch.int64, device=dev)
    cand[torch.where(valid & (rank < max_l),
                     cid * max_l + torch.clamp(rank, max=max_l - 1),
                     N * max_l)] = rows
    cand = cand[:N * max_l].view(N, max_l)
    seed_bases = bases[torch.clamp(cand, max=N - 1)]       # (N, max_l, k)

    countsf = counts.to(torch.float32)
    total_cnt = segments.drop_scatter(N, vcid, countsf)
    log_total = torch.log(torch.clamp(total_cnt, min=2.0))
    slots = torch.arange(max_l, device=dev)
    # flat index of (row's cluster, position, base) in the EM's scores,
    # the dropped slot for padding rows
    pos_base = torch.arange(k, device=dev)[None, :] * 4 + bases  # (N, k)
    drop = N * max_l * k * 4

    def run_l(l: int):
        act = (slots[None, :] < torch.clamp(csize, max=l)[:, None])[cid]

        def assign_of(centers):
            logl = torch.where(act, _logl(centers[cid], bases, lp, lrp),
                               -torch.inf)
            return logl, torch.argmax(logl, dim=-1)

        centers = seed_bases
        for _ in range(em_iters):
            _, assign = assign_of(centers)
            # M step: count-weighted per-position consensus
            # (ConsensusWithMask, kmer_cluster.cpp:49)
            idx = torch.where(valid[:, None],
                              (vcid * max_l + assign)[:, None] * (k * 4)
                              + pos_base, drop)
            scores = torch.zeros(drop + 1, dtype=torch.float32, device=dev)
            segments.index_add_float(
                scores, idx.reshape(-1),
                countsf[:, None].expand(N, k).reshape(-1), limit=drop)
            scores = scores[:drop].view(N, max_l, k, 4)
            nonempty = scores.sum(dim=-1) > 0              # (N, max_l, k)
            centers = torch.where(nonempty, torch.argmax(scores, dim=-1),
                                  centers)
        # final assignment + BIC
        logl, assign = assign_of(centers)
        best = torch.max(logl, dim=-1).values
        wl = torch.where(valid, countsf * best, 0.0)
        loglik = segments.drop_scatter(N, vcid, wl)
        nparams = (l - 1) + 3 * l * k                      # ClusterBIC:112
        bic = loglik - nparams * log_total / 2.0
        # l > cluster size is not a real model
        bic = torch.where(csize >= l, bic, -torch.inf)
        return bic, assign, centers

    best_bic, best_assign, best_centers = run_l(1)
    for l in range(2, max_l + 1):
        bic, assign, centers = run_l(l)
        better = bic > best_bic
        best_bic = torch.where(better, bic, best_bic)
        best_assign = torch.where(better[cid], assign, best_assign)
        best_centers = torch.where(better[:, None, None], centers,
                                   best_centers)

    # per-member consensus bases (the voting target)
    cons = best_centers[cid, best_assign]                  # (N, k)
    is_center = valid & torch.all(cons == bases, dim=-1)
    # subcluster quality (ProcessCluster:513-519): center_quality from
    # the center member's total_qual; cluster_quality from the product
    # of the OTHER members' total_qual
    S = N * max_l
    sub = torch.where(valid, cid * max_l + best_assign, S)
    sub_lq = segments.drop_scatter(
        S, sub, torch.where(valid, stats.total_lq, 0.0))
    # at most one center a subcluster (its rows are distinct k-mers):
    # the centers' own rows are written, not scattered
    center_sub = sub[is_center]
    center_lq = torch.zeros(S, dtype=torch.float32, device=dev)
    center_lq[center_sub] = stats.total_lq[is_center]
    has_center = torch.zeros(S, dtype=torch.bool, device=dev)
    has_center[center_sub] = True
    sub_n = segments.drop_scatter(
        S, sub, torch.ones(N, dtype=torch.int64, device=dev))
    rest_lq = sub_lq - torch.where(has_center, center_lq, 0.0)
    cluster_q = 1.0 - torch.exp(rest_lq)                   # (S,)

    center_quality = 1.0 - torch.exp(stats.total_lq)       # (N,)
    sub_safe = torch.clamp(sub, max=S - 1)
    clq = torch.where(sub_n[sub_safe] == 1, 1.0, cluster_q[sub_safe])
    good = (((center_quality > SINGLETON_THRESHOLD)
             & (clq > NONSINGLETON_THRESHOLD))
            | (center_quality > CORRECT_THRESHOLD))
    return SubClusters(solid=is_center & good, is_center=is_center,
                       center_bases=cons.to(torch.uint8),
                       rep=torch.where(valid, rep, N))


def subcluster_kmers_chunked(kmers, counts, num, stats: KmerQualStats,
                             rep, k: int, max_l: int = 4,
                             em_iters: int = 4,
                             chunk: int = SUBCLUSTER_CHUNK) -> SubClusters:
    """``subcluster_kmers`` over cluster-aligned row chunks.

    The EM holds (N, max_l, k, 4) scores; subclustering is strictly
    intra-cluster, so rows reordered by cluster split at cluster
    boundaries and each slice runs ``subcluster_kmers`` on bounded
    shapes (kmer_cluster.cpp:624 iterating cluster blocks). A cluster
    larger than ``chunk`` is cut at the chunk's edge, as in the JAX
    package: the chunk is part of the result.
    """
    N = kmers.shape[0]
    if N <= chunk:
        return subcluster_kmers(kmers, counts, num, stats, rep, k,
                                max_l=max_l, em_iters=em_iters)
    dev = kmers.device
    n = int(num)
    idx = torch.arange(N, device=dev)
    valid = idx < n
    repc = torch.where(valid, rep, 2 ** 30)
    order = segments.lexsort_perm([repc, -counts.to(torch.int64)])
    srep = repc[order]
    start_mask = torch.zeros(N, dtype=torch.bool, device=dev)
    start_mask[0] = n > 0
    start_mask[1:] = (srep[1:] != srep[:-1]) & (idx[1:] < n)
    spos = torch.nonzero(start_mask).reshape(-1).cpu().numpy()
    bounds = [0]
    while bounds[-1] < n:
        t = bounds[-1] + chunk
        if t >= n:
            bounds.append(n)
            break
        j = int(np.searchsorted(spos, t, side="right")) - 1
        cut = int(spos[max(j, 0)])
        if cut <= bounds[-1]:      # one cluster larger than the chunk
            cut = t
        bounds.append(min(cut, n))

    # gathered once into cluster order; one chunk of tail padding
    def ordered_padded(a, fill=0):
        tail = torch.full((chunk,) + tuple(a.shape[1:]), fill,
                          dtype=a.dtype, device=dev)
        return torch.cat([a[order], tail])

    kmers_o = ordered_padded(kmers, dna.WORD_MASK)
    counts_o = ordered_padded(counts)
    lq_o = ordered_padded(stats.total_lq)
    qs_o = ordered_padded(stats.qual_sum)
    rep_o = ordered_padded(torch.where(valid, rep, 0))

    solid = torch.zeros(N, dtype=torch.bool, device=dev)
    is_center = torch.zeros(N, dtype=torch.bool, device=dev)
    center_bases = torch.zeros((N, k), dtype=torch.uint8, device=dev)
    rep_out = torch.full((N,), N, dtype=torch.int64, device=dev)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        part = slice(lo, lo + chunk)
        sub = subcluster_kmers(
            kmers_o[part], counts_o[part], torch.tensor(hi - lo, device=dev),
            KmerQualStats(total_lq=lq_o[part], qual_sum=qs_o[part]),
            rep_o[part], k, max_l=max_l, em_iters=em_iters)
        dest = order[lo:hi]
        m = hi - lo
        solid[dest] = sub.solid[:m]
        is_center[dest] = sub.is_center[:m]
        center_bases[dest] = sub.center_bases[:m]
        rep_out[dest] = rep_o[lo:hi]
    return SubClusters(solid=solid, is_center=is_center,
                       center_bases=center_bases, rep=rep_out)


def _promotions(found, safe_row, lengths, solid, L: int, k: int):
    """One expansion pass over a read batch: the table rows its reads
    promote (expander.cpp:17-70), as a (M,) index list. A position is
    covered iff a solid k-mer starts in (t-k, t]; a read all of whose
    positions are covered promotes every k-mer it holds."""
    R, P = found.shape
    good = solid[safe_row] & found
    cs = torch.nn.functional.pad(torch.cumsum(good.to(torch.int32), 1),
                                 (1, 0))                    # (R, P+1)
    t = torch.arange(L, device=found.device)
    hi = torch.clamp(t + 1, max=P)
    lo = torch.clamp(t - (k - 1), min=0)
    covered = (cs[:, hi] - cs[:, lo]) > 0                   # (R, L)
    in_read = t[None, :] < lengths[:, None]
    read_ok = torch.all(covered | ~in_read, dim=1) & (lengths >= k)
    return safe_row[found & read_ok[:, None]]


def expand_solid(codes: torch.Tensor, lengths: torch.Tensor,
                 table: counter.KmerTable, solid: torch.Tensor, k: int,
                 max_rounds: int = 8, hay=None) -> torch.Tensor:
    """Iterative solid-set expansion (expander.cpp:17-70): every read
    whose positions are all covered by solid k-mers promotes all its
    k-mers to solid; batched over the reads, iterated to the fixed point
    or ``max_rounds`` rounds."""
    if hay is None:
        hay = segments.fuse_words(table.kmers)
    found, safe_row, _ = counter.lookup_windows(hay, table.num, codes,
                                                lengths, k)
    for _ in range(max_rounds):
        new_solid = solid.clone()
        new_solid[_promotions(found, safe_row, lengths, solid,
                              codes.shape[1], k)] = True
        changed = bool(torch.any(new_solid & ~solid))
        solid = new_solid
        if not changed:
            break
    return solid


def expand_chunk_reads(read_len: int, k: int, device: torch.device) -> int:
    """Reads one expansion chunk holds: on the card from its free memory
    (the windows' keys, search, rows and flags, 80 bytes a window, 24 a
    base), ``CPU_EXPAND_CHUNK_READS`` on the CPU. The chunk changes
    nothing in the result."""
    per_read = (max(read_len - k + 1, 1) * 80 + 24 * max(read_len, 1))
    return membudget.reads_per_chunk(per_read, device,
                                     CPU_EXPAND_CHUNK_READS)


def expand_solid_chunked(codes, lengths, table: counter.KmerTable,
                         solid, k: int, max_rounds: int = 8,
                         chunk_reads: int | None = None) -> torch.Tensor:
    """``expand_solid`` with the read loop chunked (expander.cpp:17-70
    over read batches): each round streams the read chunks, ORs their
    promotions, and stops at the fixed point."""
    if chunk_reads is None:
        chunk_reads = expand_chunk_reads(codes.shape[1], k, codes.device)
    hay = segments.fuse_words(table.kmers)
    R, L = codes.shape
    if R <= chunk_reads:
        return expand_solid(codes, lengths, table, solid, k,
                            max_rounds=max_rounds, hay=hay)
    for _ in range(max_rounds):
        new_solid = solid.clone()
        for lo in range(0, R, chunk_reads):
            c, ln = codes[lo:lo + chunk_reads], lengths[lo:lo + chunk_reads]
            found, safe_row, _ = counter.lookup_windows(hay, table.num, c,
                                                        ln, k)
            new_solid[_promotions(found, safe_row, ln, solid, L, k)] = True
        if not bool(torch.any(new_solid & ~solid)):
            break
        solid = new_solid
    return solid
