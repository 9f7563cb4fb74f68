"""IonTorrent homopolymer-space read correction (IonHammer equivalent).

PyTorch counterpart of the JAX package's ``hammer/ionhammer.py``
(projects/ionhammer: HKMer counting, gamma-Poisson run-length model):
IonTorrent's dominant error is a miscalled homopolymer run length, so
correction happens in homopolymer-compressed space:

1. compress each read to (base, run_length) pairs;
2. count k-mers over the compressed bases (the CUDA extraction kernel
   through ``counter.count_kmers``) and accumulate per-slot run-length
   sums and counts of every found window (the kernel's strand entry
   orients them);
3. per (solid k-mer, slot), the gamma-Poisson MAP run length (a
   conjugate Gamma(ALPHA, BETA) prior on the Poisson rate,
   gamma_poisson_model.cpp);
4. rewrite each read's interior run lengths to the consensus where solid
   k-mers agree, then decompress.

One shot over the whole read set, as in the JAX package. Run lengths
and votes are integers; only the MAP and the vote mean are float32.
"""

from __future__ import annotations

import torch

from ..kmers import counter
from ..ops import dna, segments
from ..utils.device import resolve_device

# weak conjugate prior for the run-length Poisson rate (stand-in for the
# reference's trained gamma mixture, gamma_poisson_model.cpp:40)
ALPHA = 1.0
BETA = 0.05


def hp_compress(codes: torch.Tensor, lengths: torch.Tensor):
    """(R, L) codes -> (bases (R, L) uint8, runs (R, L) int32, comp_lengths
    (R,) int32). Compressed rows are left-aligned and INVALID-padded."""
    R, L = codes.shape
    dev = codes.device
    pos = torch.arange(L, device=dev)[None, :]
    ok = (pos < lengths[:, None]) & (codes < dna.INVALID_CODE)
    prev = torch.nn.functional.pad(codes[:, :-1], (1, 0), value=255)
    new_run = ok & ((codes != prev) | (pos == 0))
    run_id = torch.cumsum(new_run.to(torch.int32), 1) - 1           # (R, L)
    # flat slot of (read, run); positions outside a run go to a dropped slot
    slot = torch.where(ok, torch.arange(R, device=dev)[:, None] * L + run_id,
                       R * L)
    # a run's positions hold one code: its first position writes it
    bases = torch.full((R * L + 1,), dna.INVALID_CODE, dtype=torch.uint8,
                       device=dev)
    bases[torch.where(new_run, slot, R * L).reshape(-1)] = codes.reshape(-1)
    bases = bases[:R * L].view(R, L)
    runs = segments.drop_scatter(
        R * L, slot.reshape(-1),
        torch.ones(R * L, dtype=torch.int32, device=dev)).view(R, L)
    clens = torch.amax(torch.where(ok, run_id + 1, 0), dim=1)
    return bases, runs, clens.to(torch.int32)


def hp_decompress(bases: torch.Tensor, runs: torch.Tensor,
                  clens: torch.Tensor, out_width: int):
    """Inverse of ``hp_compress`` into ``out_width`` columns: (codes (R,
    out_width) uint8, lengths (R,) int32)."""
    R, L = bases.shape
    dev = bases.device
    in_comp = torch.arange(L, device=dev)[None, :] < clens[:, None]
    runs = torch.where(in_comp, runs, 0)
    ends = torch.cumsum(runs, 1)                                   # (R, L)
    # output position t belongs to run j iff starts[j] <= t < ends[j]
    t = torch.arange(out_width, device=dev)
    j = torch.searchsorted(ends.contiguous(),
                           t[None, :].expand(R, out_width).contiguous()
                           .to(ends.dtype), right=True)
    out = torch.gather(bases, 1, torch.clamp(j, max=L - 1))
    lengths = torch.clamp(ends[:, -1], max=out_width)
    out = torch.where(t[None, :] < lengths[:, None], out,
                      torch.tensor(dna.INVALID_CODE, dtype=torch.uint8,
                                   device=dev))
    return out.to(torch.uint8), lengths.to(torch.int32)


def _gamma_poisson_map(rl_sum: torch.Tensor, rl_cnt: torch.Tensor
                       ) -> torch.Tensor:
    """Integer MAP run length under Poisson(l) observations with a
    Gamma(ALPHA, BETA) prior: argmax over integers of
    (S + ALPHA - 1) log l - (n + BETA) l; the continuous optimum is
    x = (S + ALPHA - 1) / (n + BETA), so floor(x) and ceil(x) compete."""
    a = rl_sum.to(torch.float32) + (ALPHA - 1.0)
    b = rl_cnt.to(torch.float32) + BETA
    x = torch.clamp(a / torch.clamp(b, min=1e-9), min=1.0)
    lo = torch.clamp(torch.floor(x), min=1.0)
    hi = lo + 1.0
    ll_lo = a * torch.log(lo) - b * lo
    ll_hi = a * torch.log(hi) - b * hi
    return torch.where(ll_hi > ll_lo, hi, lo).to(torch.int32)


def _stats_and_vote(bases, runs, clens, table: counter.KmerTable, k: int,
                    min_count: int):
    """Per-(k-mer, slot) run-length statistics, the gamma-Poisson
    consensus, and per-read run-length votes."""
    R, L = bases.shape
    N = table.capacity
    dev = bases.device
    P = L - k + 1
    found, row, is_fwd = counter.lookup_windows(
        segments.fuse_words(table.kmers), table.num, bases, clens, k)
    safe_row = torch.where(found, row, N)
    fwd = is_fwd[..., None]

    # windows of run lengths per placement: (R, P, k)
    win = runs.unfold(1, k, 1)
    # flank mask: first/last run of a read is boundary-truncated
    offs = torch.arange(k, device=dev)
    pidx = torch.arange(P, device=dev)[None, :, None]
    m = torch.ones((R, P, k), dtype=torch.int32, device=dev)
    m = torch.where((pidx == 0) & (offs == 0), 0, m)
    m = torch.where((pidx + k == clens[:, None, None]) & (offs == k - 1),
                    0, m)
    # orient into canonical space
    win_c = torch.where(fwd, win, win.flip(-1))
    m_c = torch.where(fwd, m, m.flip(-1))

    srow = safe_row.reshape(-1)
    rl_sum = torch.zeros((N + 1, k), dtype=torch.int32, device=dev)
    rl_sum.index_add_(0, srow, (win_c * m_c).reshape(-1, k))
    rl_cnt = torch.zeros((N + 1, k), dtype=torch.int32, device=dev)
    rl_cnt.index_add_(0, srow, m_c.reshape(-1, k))
    rl_sum, rl_cnt = rl_sum[:N], rl_cnt[:N]

    consensus = _gamma_poisson_map(rl_sum, rl_cnt)            # (N, k)
    solid = (table.counts >= min_count) & (rl_cnt.amin(dim=1) > 0)

    # votes back onto reads: each found+solid placement votes its
    # consensus (re-oriented) at compressed positions p..p+k-1
    rows_ = torch.clamp(safe_row, max=N - 1)
    can_vote = found & solid[rows_]
    cons = consensus[rows_]                                   # (R, P, k)
    cons_r = torch.where(fwd, cons, cons.flip(-1))
    vpos = torch.where(can_vote[..., None], pidx + offs, L)   # (R, P, k)
    flat = (torch.arange(R, device=dev)[:, None, None] * (L + 1)
            + vpos).reshape(-1)
    vote_sum = torch.zeros(R * (L + 1), dtype=torch.int32, device=dev)
    vote_sum.index_add_(0, flat, cons_r.reshape(-1))
    vote_cnt = torch.zeros(R * (L + 1), dtype=torch.int32, device=dev)
    vote_cnt.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    vote_sum = vote_sum.view(R, L + 1)[:, :L]
    vote_cnt = vote_cnt.view(R, L + 1)[:, :L]

    cols = torch.arange(L, device=dev)[None, :]
    interior = (cols >= 1) & (cols < clens[:, None] - 1)
    has = (vote_cnt > 0) & interior
    mean = vote_sum.to(torch.float32) / torch.clamp(vote_cnt, min=1).to(
        torch.float32)
    new_runs = torch.where(has, torch.round(mean).to(torch.int32), runs)
    new_runs = torch.maximum(new_runs, (cols < clens[:, None]).to(
        torch.int32))
    changed = ((new_runs != runs) & has).sum()
    return new_runs, changed, solid.sum()


def correct_reads_ion(codes, lengths, k: int = 13, min_count: int = 3,
                      device=None):
    """Correct homopolymer run lengths by solid-HK-mer gamma-Poisson
    consensus. Returns (codes, lengths, stats): tensors on ``device`` (by
    default the card the reads lie on, else the first card; the CPU only
    on request) whose width can change, since run lengths do."""
    device = resolve_device(device, codes)
    codes = torch.as_tensor(codes).to(device)
    lengths = torch.as_tensor(lengths).to(device=device, dtype=torch.int32)
    bases, runs, clens = hp_compress(codes, lengths)
    table = counter.trim_table(counter.count_kmers(bases, clens, k))
    new_runs, changed, n_solid = _stats_and_vote(
        bases, runs, clens, table, k, min_count)
    out_width = int(new_runs.sum(dim=1).max()) if len(new_runs) else 0
    out_codes, out_lengths = hp_decompress(
        bases, new_runs, clens, max(out_width, int(codes.shape[1])))
    return out_codes, out_lengths, {"changed_runs": int(changed),
                                    "solid_hkmers": int(n_solid)}
