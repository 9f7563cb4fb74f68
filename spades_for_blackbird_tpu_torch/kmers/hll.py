"""HyperLogLog k-mer cardinality estimation on the device.

PyTorch counterpart of the JAX package's ``kmers/hll.py`` (the
reference's HLL, common/adt/hll.hpp:11, used for k-mer cardinality
estimates via utils/kmer_counting.hpp:168-256 and the
spades-kmer-estimating tool, projects/kmercount/kmer_estimating.cpp:61):
the canonical k-mers come from the k-mer kernel (``kmer_cuda``, the
counting sort's keys, turned back into words), each is hashed, and the
registers are one scatter-max over the hashed stream.

The hash is the JAX package's ``kmer_hash`` (its
``parallel/kmer_exchange.py:27-33``), kept here as a copy: a
multiplicative mix over uint32 words. The port holds 32-bit words in
int64 tensors, so every product is masked back to 32 bits (the low 32
bits of a product are the same whether it wraps at 2^32 or 2^64). The
register rank is 1 + the leading zeros of the remaining 20 bits; the
JAX package takes the highest set bit from a float32 ``log2``, the port
by five integer shift steps (``tests/test_torch_hll_positions.py``
holds the two equal on all 2^20 values).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import dna, kmer_cuda, segments
from ..utils import membudget
from ..utils.device import resolve_device

_PRECISION = 12  # 4096 registers, ~1.6% relative error
_M = 1 << _PRECISION
_WIDTH = 32 - _PRECISION
_MASK32 = 0xFFFFFFFF
# reads a chunk on the CPU
CPU_CHUNK_READS = 1 << 16


def kmer_hash(words: torch.Tensor) -> torch.Tensor:
    """Cheap multiplicative mix of k-mer words (..., W) int64 holding
    uint32 values -> (...) int64 holding the uint32 hash."""
    h = torch.full(words.shape[:-1], 0x9E3779B9, dtype=torch.int64,
                   device=words.device)
    for w in range(words.shape[-1]):
        h = ((h ^ words[..., w]) * 0x85EBCA6B) & _MASK32
        h = h ^ (h >> 13)
    return (h * 0xC2B2AE35) & _MASK32


def highest_bit(x: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of each x in [1, 2^32) (int64)."""
    hb = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        hb = hb + s * ((x >> (hb + s)) > 0)
    return hb


def register_rank(rest: torch.Tensor) -> torch.Tensor:
    """Rank of the 20 bits above a register's index: leading zeros + 1,
    ``_WIDTH + 1`` when they are all zero."""
    return torch.where(rest == 0, _WIDTH + 1,
                       _WIDTH - highest_bit(torch.clamp(rest, min=1)))


def _chunk_registers(codes: torch.Tensor, lengths: torch.Tensor, k: int
                     ) -> torch.Tensor:
    W = dna.words_per_kmer(k)
    keys, valid = kmer_cuda.extract_sort_keys(codes, lengths, k)
    if valid is None:  # invalid windows hold the fused sentinel
        sent = torch.tensor(segments.fused_sentinels(W), dtype=torch.int64,
                            device=keys.device)[:, None]
        valid = ~torch.all(keys == sent, dim=0)
    words = segments.unfuse_keys(list(keys.unbind(0)), W)
    del keys
    h = kmer_hash(words)
    reg = torch.where(valid, h & (_M - 1), _M)
    return segments.drop_scatter(_M, reg, register_rank(h >> _PRECISION),
                                 "amax")


def hll_registers(codes, lengths, k: int, device=None) -> torch.Tensor:
    """HLL registers (M,) int64 (uint32 values) from a read batch's
    canonical k-mers ((R, L) uint8 codes, (R,) lengths; NumPy or
    tensors). Runs on ``device`` (``resolve_device``: the card unless
    ``"cpu"`` is asked for), in read chunks sized from its free memory;
    the chunks' registers merge by maximum."""
    device = resolve_device(device, codes)
    codes = torch.as_tensor(codes).to(device=device, dtype=torch.uint8)
    lengths = torch.as_tensor(lengths).to(device=device, dtype=torch.int32)
    R, L = codes.shape
    W = dna.words_per_kmer(k)
    G = (W + 1) // 2
    per_read = max(L - k + 1, 1) * (16 * G + 8 * W + 48)
    chunk = membudget.reads_per_chunk(per_read, device, CPU_CHUNK_READS)
    regs = torch.zeros(_M, dtype=torch.int64, device=device)
    for lo in range(0, R, chunk):
        regs = merge_registers(regs, _chunk_registers(
            codes[lo:lo + chunk].contiguous(),
            lengths[lo:lo + chunk].contiguous(), k))
    return regs


def merge_registers(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)


def estimate(registers) -> float:
    """Standard HLL estimate with small/large range corrections."""
    if isinstance(registers, torch.Tensor):
        registers = registers.cpu().numpy()
    regs = np.asarray(registers, dtype=np.float64)
    m = float(_M)
    alpha = 0.7213 / (1 + 1.079 / m)
    e = alpha * m * m / np.sum(np.exp2(-regs))
    zeros = float(np.sum(regs == 0))
    if e <= 2.5 * m and zeros > 0:
        e = m * np.log(m / zeros)  # linear counting
    return float(e)


def estimate_kmer_cardinality(codes, lengths, k: int, device=None) -> float:
    return estimate(hll_registers(codes, lengths, k, device=device))
