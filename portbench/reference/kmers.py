"""The reference's k-mer arithmetic, in plain PyTorch (any device).

It imports nothing of the program and reads nothing the program made: it
packs the benchmark's own error-free reads and truth sequences, and reads
the program's FASTA only to judge it.
"""

from __future__ import annotations

import re

import numpy as np
import torch

CHUNK_READS = 1 << 18
_M1 = -4658895280553007687   # 0xBF58476D1CE4E5B9 as int64
_M2 = -7723592293110705685   # 0x94D049BB133111EB as int64


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser: a bijection of 64-bit words."""
    x = (x ^ _shr(x, 30)) * _M1
    x = (x ^ _shr(x, 27)) * _M2
    return x ^ _shr(x, 31)


def pack(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(R, L) codes 0..3 -> (R, L - k + 1) int64, 2 bits a base, k <= 31."""
    P = codes.shape[1] - k + 1
    val = torch.zeros((codes.shape[0], P), dtype=torch.int64,
                      device=codes.device)
    for j in range(k):
        val = val * 4 + codes[:, j:j + P]
    return val


def canonical(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical k-mers of equal-length rows as one int64 key each:
    exact for k <= 31; for 31 < k <= 62 the two halves' canonical pair
    mixed into one word (collisions at 2**-64 a pair)."""
    codes = codes.to(torch.int64)
    rc = 3 - codes.flip(1)
    if k <= 31:
        return torch.minimum(pack(codes, k), pack(rc, k).flip(1))
    if k % 2 or k > 62:
        raise ValueError(f"k={k}: an even k up to 62 above 31")
    h = k // 2
    f28, r28 = pack(codes, h), pack(rc, h)
    P = codes.shape[1] - k + 1
    f1, f2 = f28[:, :P], f28[:, h:h + P]
    r1, r2 = r28[:, :P].flip(1), r28[:, h:h + P].flip(1)
    fwd_first = (f1 < r1) | ((f1 == r1) & (f2 <= r2))
    a = torch.where(fwd_first, f1, r1)
    b = torch.where(fwd_first, f2, r2)
    return mix(mix(a) ^ b)


def count_table(truth_reads: np.ndarray, k: int, device):
    """(sorted keys, counts) of the canonical k-mers of every read."""
    keys = []
    for lo in range(0, truth_reads.shape[0], CHUNK_READS):
        chunk = torch.from_numpy(truth_reads[lo:lo + CHUNK_READS]).to(device)
        keys.append(canonical(chunk, k).reshape(-1))
    return torch.unique(torch.cat(keys), sorted=True, return_counts=True)


def lookup(table, keys: torch.Tensor) -> torch.Tensor:
    """Counts of ``keys`` in a (sorted keys, counts) table, 0 if absent."""
    uniq, counts = table
    if uniq.numel() == 0:
        return torch.zeros_like(keys)
    at = torch.searchsorted(uniq, keys).clamp_(max=uniq.numel() - 1)
    return torch.where(uniq[at] == keys, counts[at], 0)


def encode(seq: str) -> np.ndarray:
    """ASCII bases -> codes 0..3, 4 for anything else."""
    table = np.full(256, 4, np.uint8)
    for i, ch in enumerate(b"ACGT"):
        table[ch] = i
    return table[np.frombuffer(seq.encode("ascii"), np.uint8)]


def pieces(seq: str, k: int):
    """The runs of ``seq`` free of N (or any non-ACGT), at least k long."""
    for part in re.split(r"[^ACGT]+", seq):
        if len(part) >= k:
            yield part


def truth_set(sources: dict, k: int, device) -> torch.Tensor:
    """Sorted canonical k-mers of the truth sequences."""
    keys = []
    for seq in sources.values():
        keys.append(canonical(torch.from_numpy(encode(seq))[None, :]
                              .to(device), k).reshape(-1))
    return torch.unique(torch.cat(keys), sorted=True)


def sequence_keys(seq: str, k: int, device) -> torch.Tensor:
    """Canonical k-mers of one sequence's N-free runs."""
    keys = [canonical(torch.from_numpy(encode(p))[None, :].to(device),
                      k).reshape(-1) for p in pieces(seq, k)]
    return (torch.cat(keys) if keys
            else torch.zeros(0, dtype=torch.int64, device=device))


def parse_fasta(text: str) -> list[tuple[str, str]]:
    """(name, sequence) records of FASTA text."""
    out, name, seq = [], None, []
    for line in text.splitlines():
        if line.startswith(">"):
            if name is not None:
                out.append((name, "".join(seq)))
            name, seq = line[1:].strip(), []
        elif line:
            seq.append(line.strip())
    if name is not None:
        out.append((name, "".join(seq)))
    return out


def name_coverage(name: str) -> float | None:
    """The coverage of a SPAdes record name (``..._cov_<c>``)."""
    m = re.search(r"_cov_([0-9.eE+-]+)", name)
    return float(m.group(1)) if m else None
