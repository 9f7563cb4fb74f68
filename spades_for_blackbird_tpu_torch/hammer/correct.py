"""Read error correction by solid-k-mer voting (BayesHammer's corrector).

PyTorch counterpart of the JAX package's ``hammer/correct.py``
(projects/hammer read_corrector.cpp:19 + expander.cpp:17): every read
position gathers votes from all k-mers covering it (a solid k-mer votes
its own bases, an erroneous k-mer its cluster center's or subcluster
consensus's bases) and the majority base wins.

Votes are integers, so their order does not matter: they are added one
k-mer offset at a time into a (R, L, 4) count, which bounds the index
tensor to one entry a window.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kmers import counter, coverage_model
from ..ops import dna, segments
from ..parallel import mesh as mesh_mod
from ..utils import membudget
from ..utils.device import resolve_device
from ..utils.logger import get_logger
from ..utils.timetrace import device_scope
from . import bayes as bayes_mod
from .cluster import HammerClusters, cluster_kmers

_log = get_logger("Hammer")

CPU_CHUNK_READS = 1 << 15  # reads a voting chunk on the CPU


class CorrectionResult(NamedTuple):
    codes: torch.Tensor          # corrected read codes
    changed_bases: torch.Tensor  # () int64
    solid_kmers: torch.Tensor    # () int64 number of solid unique kmers


def _vote(codes, lengths, bases, can_vote):
    """Majority vote: ``bases`` (R, P, k) the read-oriented bases each
    window votes for positions p..p+k-1, where ``can_vote``. A position
    adopts its majority base only with unambiguous support. Returns
    (corrected codes, changed bases)."""
    R, L = codes.shape
    P, k = bases.shape[1], bases.shape[2]
    dev = codes.device
    votes = torch.zeros(R * L * 4 + 1, dtype=torch.int32, device=dev)
    base_idx = ((torch.arange(R, device=dev)[:, None] * L
                 + torch.arange(P, device=dev)[None, :]) * 4)    # (R, P)
    ones = torch.ones(R * P, dtype=torch.int32, device=dev)
    for j in range(k):
        idx = torch.where(can_vote, base_idx + 4 * j + bases[..., j],
                          R * L * 4)
        votes.index_add_(0, idx.reshape(-1), ones)
    votes = votes[:-1].view(R, L, 4)
    best = torch.argmax(votes, dim=-1).to(torch.uint8)
    vote_total = votes.sum(dim=-1)
    vote_max = votes.max(dim=-1).values
    decided = (vote_max * 2 > vote_total) & (vote_total > 0)
    in_read = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    out = torch.where(decided & in_read, best, codes)
    changed = ((out != codes) & (codes < dna.INVALID_CODE) & in_read).sum()
    return out, changed


def _bases_of(words: torch.Tensor, k: int) -> torch.Tensor:
    """k-mer words (..., W) -> base codes (..., k) uint8, one base at a
    time: ``dna.unpack_kmers`` holds 16 int64 values a word at once."""
    out = torch.empty(words.shape[:-1] + (k,), dtype=torch.uint8,
                      device=words.device)
    for j in range(k):
        word, slot = divmod(j, dna.BASES_PER_WORD)
        out[..., j] = (words[..., word] >> (2 * (dna.BASES_PER_WORD - 1
                                                 - slot))) & 3
    return out


def _along_read(canon: torch.Tensor, is_fwd: torch.Tensor) -> torch.Tensor:
    """Canonical bases (R, P, k) oriented the way each window runs."""
    return torch.where(is_fwd[..., None], canon, (3 - canon.flip(-1)) & 3)


def correct_batch(codes: torch.Tensor, lengths: torch.Tensor,
                  table: counter.KmerTable, clusters: HammerClusters,
                  k: int, hay=None) -> CorrectionResult:
    """Voting correction with the Hamming clusters: a solid k-mer votes
    its own bases, another its cluster center's. ``hay`` is the table's
    fused keys, where the caller holds them already."""
    if hay is None:
        hay = segments.fuse_words(table.kmers)
    N = table.capacity
    found, safe_row, is_fwd = counter.lookup_windows(
        hay, table.num, codes, lengths, k)
    solid = clusters.solid[safe_row] & found
    center_row = clusters.center_of[safe_row]
    has_center = found & (center_row < N)
    vote_row = torch.where(solid, safe_row,
                           torch.clamp(center_row, max=N - 1))
    bases = _along_read(_bases_of(table.kmers[vote_row], k), is_fwd)
    out, changed = _vote(codes, lengths, bases, solid | has_center)
    return CorrectionResult(out, changed, clusters.solid.sum())


def correct_batch_bayes(codes: torch.Tensor, lengths: torch.Tensor,
                        table: counter.KmerTable, solid: torch.Tensor,
                        center_bases: torch.Tensor, k: int, hay=None
                        ) -> CorrectionResult:
    """Voting correction driven by the Bayesian subclustering: a solid
    k-mer votes its own bases; a bad k-mer votes its subcluster's
    consensus bases; a bad k-mer that is its own consensus abstains (the
    reference's bad k-mers never vote). Only found windows vote, and a
    found window's own bases are the read's bases there, so those are
    compared and voted along the read."""
    if hay is None:
        hay = segments.fuse_words(table.kmers)
    found, safe_row, is_fwd = counter.lookup_windows(
        hay, table.num, codes, lengths, k)
    is_solid = solid[safe_row] & found                     # (R, P)
    own = codes.unfold(1, k, 1)                            # (R, P, k) view
    cons = _along_read(center_bases[safe_row], is_fwd)     # (R, P, k)
    corrects = torch.any(cons != own, dim=-1)
    bases = torch.where(is_solid[..., None], own, cons)
    out, changed = _vote(codes, lengths, bases,
                         found & (is_solid | corrects))
    return CorrectionResult(out, changed, solid.sum())


def vote_chunk_reads(read_len: int, k: int, device: torch.device) -> int:
    """Reads one voting chunk holds: on the card from its free memory
    (a window's key, search, rows, flags and vote index, 96 + 8W bytes,
    and its (k,) bases eight times over; the (L, 4) votes and code
    copies, 40 bytes a base), ``CPU_CHUNK_READS`` on the CPU. Chunks of
    reads are independent, so the chunk changes nothing in the result."""
    per_read = (max(read_len - k + 1, 1)
                * (96 + 8 * k + 8 * dna.words_per_kmer(k))
                + 40 * max(read_len, 1))
    return membudget.reads_per_chunk(per_read, device, CPU_CHUNK_READS)


def _run_chunked(fn, codes, lengths, chunk: int):
    """Apply a per-read correction over read chunks (the reference's
    OpenMP read loop, read_corrector.cpp:19). ``fn(codes_chunk,
    lengths_chunk) -> CorrectionResult``."""
    R = codes.shape[0]
    if R <= chunk:
        return fn(codes, lengths)
    outs, changed, solid = [], 0, 0
    for lo in range(0, R, chunk):
        res = fn(codes[lo:lo + chunk], lengths[lo:lo + chunk])
        outs.append(res.codes)
        changed = changed + res.changed_bases
        solid = res.solid_kmers
    return CorrectionResult(torch.cat(outs), changed, solid)


def correct_reads(codes, lengths, k: int = 21, max_iterations: int = 2,
                  center_ratio: float = 10.0, quals=None,
                  bayes: bool = True, device=None,
                  chunk_reads: int | None = None):
    """Iterative BayesHammer-style correction (main loop,
    projects/hammer/main.cpp:55): count -> cluster -> correct until no
    changes or ``max_iterations``.

    With ``quals`` (raw phred+33) and ``bayes`` (the default) the
    full statistical pipeline runs: per-position quality statistics,
    Bayesian subclustering with BIC model selection and the solid-set
    expander. Without qualities the count-based center-ratio heuristic
    runs.

    The reads go to ``device``: by default the card they lie on, else
    the first card (``resolve_device``); the CPU only on request.
    ``chunk_reads`` sets the voting chunk (default: from the card's free
    memory). Returns (corrected codes, a tensor on ``device``; stats
    dict of plain numbers).

    Where a process group of world size 2 or more is initialised
    (``parallel.mesh.auto_mesh``), the quality-aware corrector runs
    sharded over it (``parallel.hammer_dist``): every rank passes the
    whole batch and gets the whole corrected batch back.
    """
    device = resolve_device(device, codes)
    codes = torch.as_tensor(codes).to(device)
    lengths = torch.as_tensor(lengths).to(device)
    if chunk_reads is None:
        chunk_reads = vote_chunk_reads(codes.shape[1], k, device)
    if quals is not None:
        quals = torch.as_tensor(quals).to(device)
        if bayes:
            mesh = mesh_mod.auto_mesh()
            if mesh is not None:
                # a process group of two or more: each rank corrects its
                # block of the reads (the OpenMP read loop,
                # projects/hammer/main.cpp:64)
                from ..parallel import hammer_dist
                mesh.check_device(device)
                return hammer_dist.make_sharded_hammer(
                    mesh, k, max_iterations=max_iterations,
                    chunk_reads=chunk_reads)(codes, lengths, quals)
            return _correct_reads_bayes(codes, lengths, quals, k,
                                        max_iterations, chunk_reads)
    total_changed = 0
    stats = {}
    for it in range(max_iterations):
        if quals is not None:
            table, qweight = counter.count_kmers_quality(
                codes, lengths, quals, k)
            # trim to pow2 unique capacity: clustering shapes scale with
            # distinct k-mers, not the R*P raw stream
            table = counter.trim_table(table)
            cluster_counts = torch.round(
                qweight[:table.capacity]).to(torch.int32)
        else:
            table = counter.trim_table(counter.count_kmers(
                codes, lengths, k))
            cluster_counts = table.counts
        ginfo = coverage_model.fit_coverage_model_hist(
            coverage_model.count_spectrum_device(cluster_counts,
                                                 table.num))
        good_thr = max(ginfo.ec_bound, 2.0)
        clusters = cluster_kmers(table.kmers, cluster_counts, table.num, k,
                                 int(good_thr), center_ratio)
        hay = segments.fuse_words(table.kmers)
        res = _run_chunked(
            lambda c, l: correct_batch(c, l, table, clusters, k, hay),
            codes, lengths, chunk_reads)
        changed = int(res.changed_bases)
        total_changed += changed
        stats = {"iterations": it + 1, "changed_bases": total_changed,
                 "solid_kmers": int(res.solid_kmers),
                 "good_threshold": good_thr}
        codes = res.codes
        if changed == 0:
            break
    return codes, stats


def _correct_reads_bayes(codes, lengths, quals, k: int,
                         max_iterations: int, chunk_reads: int,
                         merge_table=None, reduce_solid=None,
                         sum_changed=None):
    """count -> Hamming cluster -> Bayesian subcluster -> expand ->
    correct, iterated (projects/hammer/main.cpp:118-260 with
    count_do/cluster_do/bayes_do/expand_do/correct_do all on).

    The sharded corrector (``parallel.hammer_dist``) runs this loop on
    each rank's block of the reads with three steps over the mesh, each
    the identity here: ``merge_table(table, stats)`` makes the counted
    table and statistics the whole batch's, ``reduce_solid`` ORs an
    expansion round's solid mask over the ranks
    (``bayes.expand_solid_chunked``) and ``sum_changed(n)`` sums the
    changed bases, on which every rank stops alike."""
    total_changed = 0
    stats = {}
    for it in range(max_iterations):
        with device_scope("hammer_count", codes.device, it=it):
            table, qstats = bayes_mod.count_kmers_stats_chunked(
                codes, lengths, quals, k)
            if merge_table is not None:
                table, qstats = merge_table(table, qstats)
        with device_scope("hammer_cluster", codes.device, it=it):
            clusters = cluster_kmers(
                table.kmers, table.counts, table.num, k,
                2 ** 30, 0.0)  # topology only
        with device_scope("hammer_subcluster", codes.device, it=it):
            sub = bayes_mod.subcluster_kmers_chunked(
                table.kmers, table.counts, table.num, qstats,
                clusters.rep, k)
        del clusters, qstats
        with device_scope("hammer_expand", codes.device, it=it):
            solid = bayes_mod.expand_solid_chunked(
                codes, lengths, table, sub.solid, k,
                reduce_solid=reduce_solid)
        with device_scope("hammer_vote", codes.device, it=it):
            hay = segments.fuse_words(table.kmers)
            res = _run_chunked(
                lambda c, l: correct_batch_bayes(
                    c, l, table, solid, sub.center_bases, k, hay),
                codes, lengths, chunk_reads)
            changed = int(res.changed_bases)
            if sum_changed is not None:
                changed = sum_changed(changed)
        total_changed += changed
        stats = {"iterations": it + 1, "changed_bases": total_changed,
                 "solid_kmers": int(solid.sum()), "mode": "bayes"}
        _log.debug(f"iteration {it + 1}: {changed} bases changed, "
                   f"{stats['solid_kmers']} solid k-mers")
        codes = res.codes
        if changed == 0:
            break
    return codes, stats
