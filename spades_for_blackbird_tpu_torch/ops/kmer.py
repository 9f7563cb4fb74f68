"""Vectorized k-mer extraction from padded read tensors.

PyTorch counterpart of the JAX package's ``ops/kmer.py``. This is
the plain version of the CUDA extraction kernel (``ops/kmer_cuda.py``):
the kernel's wrapper runs ``extract_sort_keys`` (and, for its strand
entry, ``extract_canonical_keys``) for tensors on the CPU, and
``chip_smoke.py`` holds the kernel against them on the card.
"""

from __future__ import annotations

import torch

from . import dna, segments


def sliding_words(codes: torch.Tensor) -> torch.Tensor:
    """(R, L) codes -> (R, L) int64 where out[:, i] packs bases i..i+15.

    Bases past the end of the row are treated as 0 (A); callers mask
    validity separately.
    """
    R, L = codes.shape
    c = torch.nn.functional.pad(codes.to(torch.int64) & 3,
                                (0, dna.BASES_PER_WORD))
    out = torch.zeros((R, L), dtype=torch.int64, device=codes.device)
    for j in range(dna.BASES_PER_WORD):
        out |= c[:, j:j + L] << ((dna.BASES_PER_WORD - 1 - j) * 2)
    return out


def _window_valid(codes: torch.Tensor, lengths: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """(R, P) bool: window fits in the read and contains no N."""
    R, L = codes.shape
    P = L - k + 1
    pos = torch.arange(P, device=codes.device)
    invalid = (codes >= dna.INVALID_CODE).to(torch.int32)
    cs = torch.nn.functional.pad(torch.cumsum(invalid, 1), (1, 0))
    window_invalid = (cs[:, k:k + P] - cs[:, :P]) > 0
    in_range = pos[None, :] <= (lengths.to(torch.int64)[:, None] - k)
    return in_range & ~window_invalid


def extract_kmers(codes: torch.Tensor, lengths: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """All k-mers of a read batch.

    Args:
      codes: (R, L) uint8 base codes, INVALID_CODE for N/padding.
      lengths: (R,) actual read lengths.
      k: k-mer size.

    Returns:
      kmers: (R, P, W) int64 packed k-mer words, P = L - k + 1.
      valid: (R, P) bool -- window fits in the read and contains no N.
    """
    R, L = codes.shape
    if k > L:
        raise ValueError(f"k={k} > read length {L}")
    P = L - k + 1
    W = dna.words_per_kmer(k)
    packed = sliding_words(codes)
    pos = torch.arange(P, device=codes.device)
    word_off = torch.arange(W, device=codes.device) * dna.BASES_PER_WORD
    kmers = packed[:, pos[:, None] + word_off[None, :]]   # (R, P, W)
    mask = dna.last_word_mask(k)
    if mask != dna.WORD_MASK:
        kmers[:, :, W - 1] &= mask
    return kmers, _window_valid(codes, lengths, k)


def extract_canonical_kmers(codes: torch.Tensor, lengths: torch.Tensor,
                            k: int):
    """Canonical k-mers of a read batch.

    Returns (canon (R, P, W), valid (R, P), is_forward (R, P)).
    """
    kmers, valid = extract_kmers(codes, lengths, k)
    canon, is_fwd = dna.canonicalize_kmers(kmers, k)
    return canon, valid, is_fwd


def extract_sort_keys(codes: torch.Tensor, lengths: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Canonical k-mers of a read batch as the counting sort's keys.

    Returns (keys (G, R*P) int64, valid): ``segments.fused_cols`` of the
    canonical words, G = ceil(W/2) key columns, window (r, p) in column
    r*P + p. When k % 16 != 0 no real k-mer is all-ones: invalid windows
    then hold the fused all-ones sentinel and ``valid`` is None.
    Otherwise invalid windows hold the canonical form of their bases (N
    read as A) and ``valid`` is the (R*P,) bool column.
    """
    keys, valid, _ = extract_canonical_keys(codes, lengths, k)
    return keys, valid


def extract_canonical_keys(codes: torch.Tensor, lengths: torch.Tensor,
                           k: int):
    """``extract_sort_keys`` with the strand of every window: (keys,
    valid, is_fwd (R*P,) bool), is_fwd True where the forward k-mer is the
    canonical one (palindromes count as forward). The strand is decided on
    the window's bases, N read as A, so it is defined on invalid windows
    too."""
    canon, valid, is_fwd = extract_canonical_kmers(codes, lengths, k)
    words = canon.reshape(-1, canon.shape[-1])
    valid = valid.reshape(-1)
    sentinel_safe = k % dna.BASES_PER_WORD != 0
    if sentinel_safe:
        words = torch.where(valid[:, None], words, dna.WORD_MASK)
    keys = torch.stack(segments.fuse_words(words))
    return keys, (None if sentinel_safe else valid), is_fwd.reshape(-1)
