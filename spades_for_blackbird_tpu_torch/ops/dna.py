"""2-bit DNA primitives: encoding, complement, packed k-mer words.

PyTorch counterpart of the JAX package's ``ops/dna.py``.

- *code arrays*: ``uint8`` tensors of 2-bit codes (A=0, C=1, G=2, T=3),
  with ``INVALID_CODE`` (4) marking N/padding. Shape ``(..., L)``.
- *k-mer word arrays*: shape ``(..., W)``, each word packs 16 bases with
  the **first base in the most-significant bits** -- the JAX package's
  exact layout. Words are held in ``int64`` tensors whose values lie in
  ``[0, 2**32)`` (torch has no usable uint32 arithmetic on the CPU), so
  lexicographic order of the word tuple is DNA order and a word equals
  the reference's uint32 word bit for bit.

Every left shift is masked back to 32 bits and the bitwise NOT of a word
is ``w ^ 0xFFFFFFFF``.
"""

from __future__ import annotations

import numpy as np
import torch

# 2-bit codes. Complement(x) == 3 - x == x XOR 3 (bitwise NOT in 2 bits).
A, C, G, T = 0, 1, 2, 3
INVALID_CODE = 4  # 'N' or padding
BASES_PER_WORD = 16  # 32-bit words, 2 bits per base
WORD_MASK = 0xFFFFFFFF  # all-ones word: the padding sentinel

_CHAR_TO_CODE = np.full(256, INVALID_CODE, dtype=np.uint8)
for _ch, _code in (("A", A), ("C", C), ("G", G), ("T", T),
                   ("a", A), ("c", C), ("g", G), ("t", T)):
    _CHAR_TO_CODE[ord(_ch)] = _code
CODE_TO_CHAR = np.array([ord("A"), ord("C"), ord("G"), ord("T"), ord("N")],
                        dtype=np.uint8)


def words_per_kmer(k: int) -> int:
    """Number of 32-bit words needed for a k-mer."""
    return -(-k // BASES_PER_WORD)


def last_word_mask(k: int) -> int:
    """Mask keeping the real bases of a k-mer's last word."""
    last_bases = k - (words_per_kmer(k) - 1) * BASES_PER_WORD
    return (WORD_MASK << ((BASES_PER_WORD - last_bases) * 2)) & WORD_MASK


# ---------------------------------------------------------------------------
# Host-side string <-> code conversion (NumPy; I/O boundary only).
# ---------------------------------------------------------------------------

def encode_str(s: str) -> np.ndarray:
    """ASCII DNA string -> uint8 code array (host side)."""
    raw = np.frombuffer(s.encode("ascii"), dtype=np.uint8)
    return _CHAR_TO_CODE[raw]


def decode_codes(codes: np.ndarray) -> str:
    """uint8 code array -> ASCII DNA string (host side)."""
    codes = np.asarray(codes, dtype=np.uint8)
    return bytes(CODE_TO_CHAR[np.minimum(codes, INVALID_CODE)]).decode(
        "ascii")


def encode_reads(seqs: list[str], max_len: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """List of DNA strings -> (codes (R, L) uint8 padded, lengths (R,)
    int32)."""
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    L = int(max_len if max_len is not None
            else (lengths.max() if len(seqs) else 0))
    codes = np.full((len(seqs), L), INVALID_CODE, dtype=np.uint8)
    for i, s in enumerate(seqs):
        n = min(len(s), L)
        codes[i, :n] = encode_str(s[:n])
    return codes, lengths


_RC_TABLE = str.maketrans("ACGTacgtN", "TGCAtgcaN")


def revcomp_str(seq: str) -> str:
    """Reverse-complement of an ASCII sequence string (host-side)."""
    return seq.translate(_RC_TABLE)[::-1]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement of one host code row; INVALID stays INVALID
    (and moves to the front with the rest)."""
    return np.where(codes >= INVALID_CODE, codes, 3 - codes)[::-1]


def complement_codes(codes: torch.Tensor) -> torch.Tensor:
    """Complement 2-bit codes; INVALID stays INVALID."""
    return torch.where(codes >= INVALID_CODE, codes, 3 - codes)


def revcomp_reads(codes: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse-complement a padded read batch (R, L), keeping each read
    left-aligned (padding stays at the end)."""
    L = codes.shape[1]
    rc = torch.flip(complement_codes(codes), dims=(1,))
    shift = (L - lengths.to(torch.int64))[:, None]
    col = (torch.arange(L, device=codes.device)[None, :] + shift) % L
    return torch.gather(rc, 1, col)


# ---------------------------------------------------------------------------
# Packed k-mer words.
# ---------------------------------------------------------------------------

def _reverse_bases_in_word(w: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 2-bit base slots within each 32-bit word."""
    w = ((w & 0x0000FFFF) << 16) | ((w & 0xFFFF0000) >> 16)
    w = ((w & 0x00FF00FF) << 8) | ((w & 0xFF00FF00) >> 8)
    w = ((w & 0x0F0F0F0F) << 4) | ((w & 0xF0F0F0F0) >> 4)
    w = ((w & 0x33333333) << 2) | ((w & 0xCCCCCCCC) >> 2)
    return w


def _shifts(device) -> torch.Tensor:
    return torch.arange(BASES_PER_WORD - 1, -1, -1, dtype=torch.int64,
                        device=device) * 2


def pack_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Pack base codes (..., k) -> k-mer words (..., W) int64.

    Caller guarantees codes are valid (0..3); invalid positions must be
    masked out separately.
    """
    W = words_per_kmer(k)
    pad = W * BASES_PER_WORD - k
    c = codes.to(torch.int64) & 3
    if pad:
        c = torch.nn.functional.pad(c, (0, pad))
    c = c.reshape(codes.shape[:-1] + (W, BASES_PER_WORD))
    return (c << _shifts(codes.device)).sum(-1)


def unpack_kmers(words: torch.Tensor, k: int) -> torch.Tensor:
    """k-mer words (..., W) -> base codes (..., k) uint8."""
    W = words_per_kmer(k)
    bases = (words[..., :, None] >> _shifts(words.device)) & 3
    bases = bases.reshape(words.shape[:-1] + (W * BASES_PER_WORD,))
    return bases[..., :k].to(torch.uint8)


def _zeros_cols(words: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(words.shape[:-1] + (n,), dtype=torch.int64,
                       device=words.device)


def revcomp_kmers(words: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse-complement packed k-mers (..., W) -> (..., W).

    Complement = bitwise NOT (2-bit codes); reversal = per-word base
    reversal + word-order reversal + left shift to drop the pad slots.
    """
    W = words_per_kmer(k)
    pad_bits = (W * BASES_PER_WORD - k) * 2
    rev = torch.flip(_reverse_bases_in_word(words ^ WORD_MASK), dims=(-1,))
    if pad_bits == 0:
        return rev
    word_shift, bit_shift = divmod(pad_bits, 32)
    if word_shift:
        rev = torch.cat([rev[..., word_shift:], _zeros_cols(rev, word_shift)],
                        dim=-1)
    if bit_shift:
        hi = (rev << bit_shift) & WORD_MASK
        lo = torch.cat([rev[..., 1:], _zeros_cols(rev, 1)],
                       dim=-1) >> (32 - bit_shift)
        rev = hi | lo
    mask = last_word_mask(k)
    if mask != WORD_MASK:
        rev = rev.clone()
        rev[..., W - 1] &= mask
    return rev


def kmer_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over trailing word axis. Returns bool (...,)."""
    lt = a < b
    eq = a == b
    result = lt[..., -1]
    for w in range(a.shape[-1] - 2, -1, -1):
        result = lt[..., w] | (eq[..., w] & result)
    return result


def canonicalize_kmers(words: torch.Tensor, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Canonical form = min(kmer, revcomp(kmer)).

    Returns (canonical_words (..., W), is_forward (...,) bool); ties
    (palindromes) count as forward.
    """
    rc = revcomp_kmers(words, k)
    rc_lt = kmer_less(rc, words)
    canon = torch.where(rc_lt[..., None], rc, words)
    return canon, ~rc_lt


def truncate_bases(words: torch.Tensor, k_in: int, k_out: int) -> torch.Tensor:
    """Keep the first ``k_out`` bases of packed ``k_in``-mers (prefix)."""
    if k_out > k_in:
        raise ValueError(f"k_out={k_out} > k_in={k_in}")
    W_out = words_per_kmer(k_out)
    out = words[..., :W_out]
    mask = last_word_mask(k_out)
    if mask != WORD_MASK:
        out = out.clone()
        out[..., W_out - 1] &= mask
    return out


def drop_first_bases(words: torch.Tensor, m: int, k_in: int) -> torch.Tensor:
    """Drop the first ``m`` bases of packed ``k_in``-mers -> (k_in-m)-mers."""
    k_out = k_in - m
    word_shift, base_shift = divmod(m, BASES_PER_WORD)
    if word_shift:
        words = torch.cat([words[..., word_shift:],
                           _zeros_cols(words, word_shift)], dim=-1)
    if base_shift:
        s = base_shift * 2
        hi = (words << s) & WORD_MASK
        lo = torch.cat([words[..., 1:], _zeros_cols(words, 1)],
                       dim=-1) >> (32 - s)
        words = hi | lo
    return truncate_bases(words, words.shape[-1] * BASES_PER_WORD, k_out)


def append_base(words: torch.Tensor, k: int, base: torch.Tensor
                ) -> torch.Tensor:
    """Append one base to packed k-mers -> (k+1)-mers.

    ``base`` is broadcastable to ``words.shape[:-1]`` with values 0..3.
    """
    W_out = words_per_kmer(k + 1)
    if W_out > words.shape[-1]:
        words = torch.cat([words, _zeros_cols(words, W_out - words.shape[-1])],
                          dim=-1)
    else:
        words = words.clone()
    w0, slot = divmod(k, BASES_PER_WORD)
    shift = (BASES_PER_WORD - 1 - slot) * 2
    words[..., w0] |= base.to(torch.int64) << shift
    return words


def kmer_last_base(words: torch.Tensor, k: int) -> torch.Tensor:
    """Last base code of each packed k-mer (..., W) -> (...,) uint8."""
    W = words_per_kmer(k)
    last_bases = k - (W - 1) * BASES_PER_WORD
    shift = (BASES_PER_WORD - last_bases) * 2
    return ((words[..., W - 1] >> shift) & 3).to(torch.uint8)


def kmer_first_base(words: torch.Tensor, k: int) -> torch.Tensor:
    """First base code of each packed k-mer -> (...,) uint8."""
    return ((words[..., 0] >> 30) & 3).to(torch.uint8)
