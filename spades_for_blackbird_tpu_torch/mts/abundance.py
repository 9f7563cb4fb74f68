"""Multi-sample k-mer multiplicity and contig abundance profiles.

PyTorch counterpart of the JAX package's ``mts/abundance.py`` (the
reference mts tools):

- :func:`multiplicity_profiles` — ``kmer_multiplicity_counter``
  (projects/mts/kmer_multiplicity_counter.cpp): one canonical k-mer
  table a sample (``kmers/counter.py``, the extraction kernel on a
  card), joined on the device into a (k-mer -> per-sample multiplicity)
  matrix with one sort of the union.
- :func:`contig_abundance` — ``contig_abundance_counter``
  (projects/mts/contig_abundance_counter.cpp + contig_abundance.cpp):
  per-contig per-sample abundance = median k-mer multiplicity of the
  contig's k-mers (the reference's default "median" ProfileCounter).
  The contigs' canonical k-mers come from the kernel's strand entry and
  are searched in the profile table on the device; the medians are
  taken on the host, as in the JAX package.
- profile save/load in .npz, the JAX package's format (uint32 words,
  int32 multiplicities, the k), so either package reads the other's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kmers.counter import count_kmers_chunked
from ..ops import dna, kmer_cuda, segments
from ..utils.device import resolve_device


def multiplicity_profiles(sample_batches: list[tuple], k: int,
                          min_mult: int = 1, device=None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Count canonical k-mers of each sample and join into one profile
    matrix, on ``device`` (``resolve_device``: the card unless ``"cpu"``
    is asked for). ``sample_batches``: list of (codes, lengths).

    Returns (kmers (D, W) uint32 sorted rows, mult (D, S) int32), keeping
    k-mers whose *total* multiplicity is >= min_mult.
    """
    device = resolve_device(device)
    kms, cts = [], []
    for c, ln in sample_batches:
        t = count_kmers_chunked(
            torch.as_tensor(c).to(device=device, dtype=torch.uint8),
            torch.as_tensor(ln).to(device=device, dtype=torch.int32), k)
        num = int(t.num)
        kms.append(t.kmers[:num])
        cts.append(t.counts[:num])
        del t
    S = len(kms)
    all_k = torch.cat(kms)
    all_c = torch.cat(cts)
    all_s = torch.cat([torch.full((len(c),), i, dtype=torch.int64,
                                  device=device) for i, c in enumerate(cts)])
    del kms, cts
    keys = segments.fuse_words(all_k)
    perm = segments.lexsort_perm(keys)
    new = segments.run_heads([key[perm] for key in keys])
    gid = torch.cumsum(new, 0) - 1
    D = int(gid[-1]) + 1 if len(gid) else 0
    kmers = all_k[perm][new]
    mult = torch.zeros((D, S), dtype=torch.int32, device=device)
    mult[gid, all_s[perm]] = all_c[perm].to(torch.int32)
    keep = mult.sum(dim=1) >= min_mult
    return (kmers[keep].cpu().numpy().astype(np.uint32),
            mult[keep].cpu().numpy())


def save_profiles(path: str, kmers: np.ndarray, mult: np.ndarray,
                  k: int) -> None:
    np.savez_compressed(path, kmers=kmers, mult=mult, k=np.int32(k))


def load_profiles(path: str):
    z = np.load(path)
    return z["kmers"], z["mult"], int(z["k"])


def _contig_kmer_rows(seqs: list[str], kmers: np.ndarray, k: int,
                      device=None):
    """For each contig: indices of its canonical k-mers in ``kmers``
    (-1 = absent), window by window. Returns a list of int64 arrays.
    Each contig is cut into rows of at most ``kmer_cuda.MAX_L`` bases
    that overlap by k - 1, so a row's windows are consecutive windows of
    the contig; the rows' keys come from the kernel's strand entry and
    are searched in the table on ``device`` (the card unless ``"cpu"``
    is asked for)."""
    if not seqs:
        return []
    device = resolve_device(device)
    stride = kmer_cuda.MAX_L - k + 1
    rows, owner = [], []
    for i, s in enumerate(seqs):
        for lo in range(0, max(len(s) - k + 1, 0), stride):
            rows.append(s[lo:lo + kmer_cuda.MAX_L])
            owner.append(i)
    out = [np.zeros(0, np.int64) for _ in seqs]
    if not rows:
        return out
    codes, lengths = dna.encode_reads(rows)
    codes_t = torch.from_numpy(codes).to(device)
    lengths_t = torch.from_numpy(lengths).to(device)
    keys, valid, _ = kmer_cuda.extract_canonical_keys(codes_t, lengths_t,
                                                      k)
    R, L = codes.shape
    P = L - k + 1
    table = torch.from_numpy(np.asarray(kmers).astype(np.int64)).to(device)
    D = table.shape[0]
    found_row = segments.search_keys(segments.fuse_words(table),
                                     list(keys.unbind(0)))
    ok = torch.arange(P, device=device)[None, :] <= (
        lengths_t[:, None].to(torch.int64) - k)
    if valid is not None:
        ok &= valid.view(R, P)
    else:  # a window with an N holds the sentinel key
        sentinel = segments.fused_sentinels(dna.words_per_kmer(k))
        is_sentinel = torch.ones(R * P, dtype=torch.bool, device=device)
        for key, value in zip(keys.unbind(0), sentinel):
            is_sentinel &= key == value
        ok &= ~is_sentinel.view(R, P)
    found_row = torch.where(found_row.view(R, P) < D,
                            found_row.view(R, P), -1)
    got = found_row.cpu().numpy()
    ok = ok.cpu().numpy()
    parts: list[list[np.ndarray]] = [[] for _ in seqs]
    for r, i in enumerate(owner):
        parts[i].append(got[r][ok[r]])
    return [np.concatenate(p) if p else out[i] for i, p in enumerate(parts)]


def contig_abundance(seqs: list[str], kmers: np.ndarray, mult: np.ndarray,
                     k: int, stat: str = "median",
                     device=None) -> np.ndarray:
    """(C, S) abundance profiles; absent k-mers count as multiplicity 0
    (contig_abundance.cpp's behaviour for unseen k-mers)."""
    rows_per = _contig_kmer_rows(seqs, kmers, k, device=device)
    S = mult.shape[1]
    out = np.zeros((len(seqs), S), np.float32)
    for i, rr in enumerate(rows_per):
        if len(rr) == 0:
            continue
        m = np.zeros((len(rr), S), np.float32)
        has = rr >= 0
        m[has] = mult[rr[has]]
        out[i] = np.median(m, axis=0) if stat == "median" \
            else m.mean(axis=0)
    return out


def fragments(seq: str, k: int, frag_size: int) -> list[str]:
    """The frag_size windows of a sequence that are longer than k."""
    frags = [seq[i:i + frag_size]
             for i in range(0, max(len(seq) - frag_size + 1, 1), frag_size)]
    return [f for f in frags if len(f) > k]


def fragment_abundance(seq: str, kmers: np.ndarray, mult: np.ndarray,
                       k: int, frag_size: int, device=None) -> np.ndarray:
    """Per-fragment profiles of one sequence (series_analysis.cpp's
    edge_fragments_mpl with frag_size windows)."""
    frags = fragments(seq, k, frag_size)
    if not frags:
        return np.zeros((0, mult.shape[1]), np.float32)
    return contig_abundance(frags, kmers, mult, k, device=device)
