"""Sorted-multiset machinery: multi-word sort, run-length unique/count,
compaction, vectorised binary search.

PyTorch counterpart of the JAX package's ``ops/segments.py``.
Variable-size results are returned as padded tensors plus a 0-dim count
tensor, as in the JAX package.

``torch.sort`` takes one key, where ``lax.sort`` takes several. A
multi-word sort is therefore a series of stable argsort passes, least
significant key first. Pairs of 32-bit words are fused into one int64
key, ``((w_hi << 32) | w_lo) ^ (1 << 63)``, whose signed order is the
unsigned order of the pair: that halves the number of passes.

Out-of-range scatter indices, which JAX drops (``mode="drop"``), are sent
to one extra slot past the end of the target and sliced off.

Every float scatter-add goes through ``index_add_float``: on the CPU it
is ``index_add_``, which adds a slot's terms in row order (the order of
XLA's CPU scatter, which the parity tests rest on); on the card the
rows are sorted by slot once (stable, int32 keys, the rows aimed at no
slot keyed last) and each slot's run added in row order by the
``seg_sum`` kernel (``ops/seg_sum.py``), which skips the dropped run:
the CPU's bits on every run, where the card's
``index_add_`` adds in the order its threads arrive. Integer sums keep
``index_add_``: integer adds are exact in any order.
"""

from __future__ import annotations

import math

import torch

from .dna import WORD_MASK
from .seg_sum import seg_sum

_SIGN = -(1 << 63)  # int64 with only the sign bit set


def fused_cols(cols: list[torch.Tensor]) -> list[torch.Tensor]:
    """W word columns (each (N,)) -> ceil(W/2) int64 keys whose signed
    lexicographic order equals the words' lexicographic order (most
    significant first). A lone last word keeps its own value, which is
    non-negative."""
    out = []
    for w in range(0, len(cols) - 1, 2):
        out.append(((cols[w] << 32) | cols[w + 1]) ^ _SIGN)
    if len(cols) % 2:
        out.append(cols[-1])
    return out


def fuse_words(keys: torch.Tensor) -> list[torch.Tensor]:
    """``fused_cols`` for row-major words (N, W)."""
    return fused_cols(list(keys.unbind(1)))


def unfuse_keys(keys: list[torch.Tensor], n_words: int) -> torch.Tensor:
    """Inverse of ``fused_cols``: ceil(W/2) int64 keys (each (N,)) ->
    (N, W) words in [0, 2^32). The words are written column by column
    into the result, so no second copy of the table is held."""
    out = torch.empty((keys[0].shape[0], n_words), dtype=torch.int64,
                      device=keys[0].device)
    for g, key in enumerate(keys):
        if 2 * g + 1 < n_words:
            pair = key ^ _SIGN
            out[:, 2 * g] = (pair >> 32) & WORD_MASK
            out[:, 2 * g + 1] = pair & WORD_MASK
        else:
            out[:, 2 * g] = key
    return out


def fused_sentinels(n_words: int) -> list[int]:
    """The ``fused_cols`` keys of an all-ones row of ``n_words`` words."""
    pairs = [(1 << 63) - 1] * (n_words // 2)
    return pairs + [WORD_MASK] if n_words % 2 else pairs


def lexsort_perm(keys: list[torch.Tensor]) -> torch.Tensor:
    """Stable permutation sorting by ``keys`` (most significant first)."""
    perm = torch.sort(keys[-1], stable=True).indices
    for key in reversed(keys[:-1]):
        order = torch.sort(key[perm], stable=True).indices
        perm = perm[order]
    return perm


def sort_by_key_rows(keys: torch.Tensor, payloads: tuple = (),
                     valid: torch.Tensor | None = None):
    """Sort rows of ``keys`` (N, W) lexicographically over the word axis.

    If ``valid`` is given, invalid rows sort after all valid rows. The
    sort is stable. Payloads (each shape (N, ...)) are permuted alongside.
    Returns (sorted_keys, sorted_payloads, sorted_valid).
    """
    sort_keys = fuse_words(keys)
    if valid is not None:
        sort_keys = [(~valid).to(torch.int64)] + sort_keys
    perm = lexsort_perm(sort_keys)
    sorted_valid = valid[perm] if valid is not None else None
    return keys[perm], tuple(p[perm] for p in payloads), sorted_valid


def rows_equal_prev(keys: torch.Tensor) -> torch.Tensor:
    """(N, W) -> (N,) bool: row equals previous row (row 0 -> False)."""
    eq = torch.all(keys[1:] == keys[:-1], dim=1)
    return torch.cat([torch.zeros(1, dtype=torch.bool, device=keys.device),
                      eq])


def run_heads(cols: list[torch.Tensor]) -> torch.Tensor:
    """(N,) bool: row i of sorted key columns (each (N,)) starts a run of
    equal rows (row 0 always does)."""
    n = cols[0].shape[0]
    head = torch.ones(n, dtype=torch.bool, device=cols[0].device)
    if n:
        differs = cols[0][1:] != cols[0][:-1]
        for c in cols[1:]:
            differs |= c[1:] != c[:-1]
        head[1:] = differs
    return head


def unique_counts(sorted_keys: torch.Tensor, sorted_valid: torch.Tensor,
                  weights: torch.Tensor | None = None):
    """Run-length encode sorted rows.

    Returns (uniq (N, W) with all-ones padding past ``num_unique``,
    counts (N,), gid (N,) group id of each input row, num_unique 0-dim).
    """
    N, W = sorted_keys.shape
    dev = sorted_keys.device
    seg_start = (~rows_equal_prev(sorted_keys)) & sorted_valid
    gid = torch.clamp(torch.cumsum(seg_start, 0) - 1, min=0)
    num_unique = seg_start.sum()
    scatter_gid = torch.where(sorted_valid, gid, N)
    uniq = torch.full((N + 1, W), WORD_MASK, dtype=torch.int64, device=dev)
    uniq[scatter_gid] = sorted_keys
    if weights is None:
        weights = torch.ones(N, dtype=torch.int32, device=dev)
    counts = torch.zeros(N + 1, dtype=weights.dtype, device=dev)
    if weights.is_floating_point():
        index_add_float(counts, scatter_gid, weights, limit=N)
    else:
        counts.index_add_(0, scatter_gid, weights)
    return uniq[:N], counts[:N], gid, num_unique


def _sort_keys(keys: list[torch.Tensor], valid: torch.Tensor | None,
               sentinels: list[int]):
    """The stable permutation sorting the fused keys (invalid rows last),
    the sorted keys and their validity."""
    if valid is None:
        perm = lexsort_perm(keys)
    else:
        perm = lexsort_perm([(~valid).to(torch.int64)] + list(keys))
    skeys = [c[perm] for c in keys]
    if valid is not None:
        return perm, skeys, valid[perm]
    is_sentinel = skeys[0] == sentinels[0]
    for c, sent in zip(skeys[1:], sentinels[1:]):
        is_sentinel &= c == sent
    return perm, skeys, ~is_sentinel


def _encode_runs(skeys: list[torch.Tensor], svalid: torch.Tensor,
                 sentinels: list[int]):
    """Run-length encode sorted fused keys: (unique keys padded with the
    sentinel, counts (N,) int32, number of runs, the run of each sorted
    row (N for invalid rows))."""
    N = skeys[0].shape[0]
    dev = skeys[0].device
    seg_start = run_heads(skeys) & svalid
    scatter_gid = torch.where(svalid, torch.cumsum(seg_start, 0) - 1, N)
    uniq = []
    for c, sent in zip(skeys, sentinels):
        col = torch.full((N + 1,), sent, dtype=torch.int64, device=dev)
        col[scatter_gid] = c
        uniq.append(col[:N])
    counts = torch.zeros(N + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, scatter_gid,
                      torch.ones(N, dtype=torch.int32, device=dev))
    return uniq, counts[:N], seg_start.sum(), scatter_gid


def count_sorted_keys(keys: list[torch.Tensor], n_words: int,
                      valid: torch.Tensor | None = None):
    """Sort and run-length encode rows given as their ``fused_cols`` keys
    (the extraction kernel's layout: ceil(W/2) tensors of shape (N,)).

    The keys are sorted as they are. With ``valid`` None the invalid
    rows are those that hold the fused all-ones sentinel (the caller
    guarantees that no real row does); otherwise ``valid`` sorts as the
    leading key. Only the run-length encoded rows are unfused, after the
    sorted keys and the indices have been let go: the table is the peak
    of a counting chunk's memory. Returns (uniq (N, W) words with
    all-ones padding, counts (N,) int32, num_unique 0-dim), as
    ``count_sorted`` does.
    """
    sentinels = fused_sentinels(n_words)
    perm, skeys, svalid = _sort_keys(keys, valid, sentinels)
    del perm
    uniq, counts, num_unique, gid = _encode_runs(skeys, svalid, sentinels)
    del skeys, svalid, gid
    return unfuse_keys(uniq, n_words), counts, num_unique


def group_sorted_keys(keys: list[torch.Tensor], n_words: int,
                      valid: torch.Tensor | None = None):
    """``count_sorted_keys`` that also returns what a caller needs to
    reduce the rows' payloads by run: (uniq, counts, num_unique, perm, gid)
    with ``perm`` the stable sort permutation and ``gid`` (N,) the run of
    each sorted row, N for an invalid one (``drop_scatter``'s dropped
    slot)."""
    sentinels = fused_sentinels(n_words)
    perm, skeys, svalid = _sort_keys(keys, valid, sentinels)
    uniq, counts, num_unique, gid = _encode_runs(skeys, svalid, sentinels)
    del skeys, svalid
    return unfuse_keys(uniq, n_words), counts, num_unique, perm, gid


def count_sorted(keys: torch.Tensor, valid: torch.Tensor,
                 weights: torch.Tensor | None = None,
                 sentinel_safe: bool = False):
    """sort + unique_counts in one call. Returns (uniq, counts, num_unique).

    sentinel_safe: caller guarantees no real key row is all-ones (true for
    packed k-mers whenever k % 16 != 0 -- the pad bits are always zero).
    Validity then folds into the keys (invalid -> all-ones) and no
    validity key is sorted.
    """
    if sentinel_safe and weights is None:
        skeys = torch.where(valid[:, None], keys, WORD_MASK)
        return count_sorted_keys(fuse_words(skeys), keys.shape[1])
    payloads = (weights,) if weights is not None else ()
    skeys, spayloads, svalid = sort_by_key_rows(keys, payloads, valid)
    w = spayloads[0] if weights is not None else None
    uniq, counts, _, num_unique = unique_counts(skeys, svalid, w)
    return uniq, counts, num_unique


def sorted_slots(index: torch.Tensor, n: int):
    """(slot, perm): ``index`` sorted by a stable sort (row order kept
    within a slot) and the permutation that sorts it. A row aimed at
    ``n`` or past it is keyed ``n``, so every dropped row sorts last. The
    keys are int32 while ``n < 2**31`` (half the radix passes of int64
    keys), int64 above."""
    if n < 2 ** 31:
        keys = index.clamp(max=n).to(torch.int32)
    else:
        keys = index.to(torch.int64).clamp(max=n)
    return torch.sort(keys, stable=True)


def ordered_index_add_(out: torch.Tensor, index: torch.Tensor,
                       src: torch.Tensor, limit: int | None = None
                       ) -> torch.Tensor:
    """``out.index_add_(0, index, src)`` with each slot's terms added in
    row order from the slot's value, on any device: the rows are sorted
    by slot (``sorted_slots``) and ``seg_sum`` adds the sorted runs below
    ``limit`` (default ``len(out)``); the rows aimed at ``limit`` or past
    it are dropped, and rows ``>= limit`` of ``out`` are left as they
    are. ``out`` must be contiguous; ``src`` is (len(index), ...) like a
    row of ``out``. Returns ``out``.

    Rows of one value are read by the kernel through the sort's
    permutation; rows of several values are copied out in sorted order
    first (``index_select``), so that the kernel's long runs stream
    contiguous rows. On the card each is the faster of the two there
    (PERF.md, section 6)."""
    n = out.shape[0] if limit is None else limit
    slot, perm = sorted_slots(index, n)
    cols = math.prod(out.shape[1:])
    rows = src.reshape(index.shape[0], cols)
    if cols == 1:
        seg_sum(out.view(out.shape[0], 1), slot, rows, perm=perm, limit=n)
    else:
        seg_sum(out.view(out.shape[0], cols), slot, rows[perm], limit=n)
    return out


def index_add_float(out: torch.Tensor, index: torch.Tensor,
                    src: torch.Tensor, limit: int | None = None
                    ) -> torch.Tensor:
    """The float scatter-add of the port, in place: ``out.index_add_(0,
    index, src)`` with the CPU's bits on every device. On the CPU it is
    ``index_add_`` itself; on the card ``ordered_index_add_`` (which
    raises for a dtype other than float32 or float64). Rows of ``out`` at
    ``limit`` or past it are a caller's dropped slots, which it slices
    off: the card does not sum them."""
    if out.device.type == "cpu":
        return out.index_add_(0, index, src)
    return ordered_index_add_(out, index, src, limit)


def drop_scatter(n: int, index: torch.Tensor, src: torch.Tensor,
                 reduce: str = "sum", init=0) -> torch.Tensor:
    """(n,) tensor filled with ``init``, with ``src`` reduced into it at
    ``index`` ("sum", "amax" or "amin"). Index ``n`` is dropped, as JAX's
    ``.at[index].add/max/min(src, mode="drop")`` drops it: float sums
    through ``index_add_float``; before a max or a min the dropped rows
    are taken out, so their atomics do not queue on one slot."""
    out = torch.full((n + 1,), init, dtype=src.dtype, device=src.device)
    if reduce == "sum":
        if src.is_floating_point():
            index_add_float(out, index, src, limit=n)
        else:
            out.index_add_(0, index, src)
    else:
        keep = index < n
        out.scatter_reduce_(0, index[keep], src[keep], reduce,
                            include_self=True)
    return out[:n]


def compact(mask: torch.Tensor, *arrays: torch.Tensor):
    """Stable-pack rows where ``mask`` is True to the front.

    Returns (num_kept 0-dim, packed_arrays); slots past num_kept are zero.
    """
    N = mask.shape[0]
    dest = torch.where(mask, torch.cumsum(mask, 0) - 1, N)
    num_kept = mask.sum()
    outs = []
    for a in arrays:
        out = torch.zeros((N + 1,) + a.shape[1:], dtype=a.dtype,
                          device=a.device)
        out[dest] = a
        outs.append(out[:N])
    return num_kept, tuple(outs)


def searchsorted_rows(haystack: torch.Tensor, needles: torch.Tensor
                      ) -> torch.Tensor:
    """Binary search rows of ``needles`` (M, W) in sorted ``haystack`` (N, W).

    Returns (M,) int64 index of the first haystack row == needle, or N if
    absent. Compares fused int64 word pairs (see ``fuse_words``).
    """
    return search_keys(fuse_words(haystack), fuse_words(needles))


def search_keys(hay: list[torch.Tensor], needles: list[torch.Tensor]
                ) -> torch.Tensor:
    """``searchsorted_rows`` on rows given as their ``fused_cols`` keys:
    ``hay`` G tensors (N,) of a sorted table, which a caller that searches
    it many times fuses once; ``needles`` G tensors (M,), as the extraction
    kernel writes them. Returns (M,) int64: the first table row equal to
    the needle, or N if absent. One key column is one ``torch.searchsorted``;
    more are searched a halving round at a time. The [lo, hi) gap starts
    at N and halves a round; it must reach 0, which takes ceil(log2(N+1))
    <= N.bit_length() rounds ((N-1).bit_length() is one short when N is a
    power of two)."""
    N = hay[0].shape[0]
    if N == 0:
        return torch.zeros_like(needles[0])
    if len(hay) == 1:
        lo = torch.searchsorted(hay[0], needles[0])
    else:
        M = needles[0].shape[0]
        dev = needles[0].device
        lo = torch.zeros(M, dtype=torch.int64, device=dev)
        hi = torch.full((M,), N, dtype=torch.int64, device=dev)
        for _ in range(max(1, N.bit_length())):
            mid = (lo + hi) // 2
            safe = torch.clamp(mid, max=N - 1)
            lt = hay[-1][safe] < needles[-1]
            for h, n in zip(reversed(hay[:-1]), reversed(needles[:-1])):
                hm = h[safe]
                lt = (hm < n) | ((hm == n) & lt)
            lo = torch.where(lt, mid + 1, lo)
            hi = torch.where(lt, hi, mid)
    safe = torch.clamp(lo, max=N - 1)
    found = lo < N
    for h, n in zip(hay, needles):
        found &= h[safe] == n
    return torch.where(found, lo, N)
