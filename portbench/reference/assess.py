"""Assembly-quality assessment against a known truth genome: a frozen copy
of the program's ``utils/assess.py``, so that the benchmark's grading
does not move with the program.

A compact, dependency-free QUAST analogue: contigs are anchored to the
truth via unique 31-mers, anchors are grouped into colinear blocks
(consistent diagonal + strand), and a block break of more than
``relocation_bp`` counts as a misassembly, the same relocation rule
QUAST applies. Reports N50/NG50, genome fraction, largest contig,
mismatch-free alignment status.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_CODE = np.full(256, 255, np.uint8)
for i, b in enumerate(b"ACGT"):
    _CODE[b] = i
_COMP_CODE = np.array([3, 2, 1, 0], np.uint8)

K = 31  # anchor k-mer; fits in 62 bits of an int64


def _pack_kmers(codes: np.ndarray, k: int = K) -> np.ndarray:
    """All k-mers of a code vector packed to int64 (2 bits/base)."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    out = np.zeros(n, np.int64)
    for j in range(k):
        out = (out << 2) | codes[j:j + n].astype(np.int64)
    return out


@dataclass
class AssessReport:
    n_contigs: int = 0
    total_length: int = 0
    largest: int = 0
    n50: int = 0
    ng50: int = 0
    genome_length: int = 0
    genome_fraction: float = 0.0
    misassemblies: int = 0
    unaligned_contigs: int = 0
    duplication_ratio: float = 0.0
    per_contig: list = field(default_factory=list)

    def to_dict(self):
        d = self.__dict__.copy()
        d.pop("per_contig")
        return d


def _nx(lengths: np.ndarray, target: float) -> int:
    if len(lengths) == 0:
        return 0
    s = np.sort(lengths)[::-1]
    csum = np.cumsum(s)
    i = int(np.searchsorted(csum, target))
    return int(s[min(i, len(s) - 1)]) if csum[-1] >= target else 0


def assess(contigs: list[str], genome: str, stride: int = 16,
           relocation_bp: int = 1000) -> AssessReport:
    g = _CODE[np.frombuffer(genome.encode(), np.uint8)]
    G = len(g)
    gk = _pack_kmers(g)
    order = np.argsort(gk, kind="stable")
    gk_sorted = gk[order]
    # unique genome k-mers only: repeats are ambiguous anchors
    first = np.concatenate([[True], gk_sorted[1:] != gk_sorted[:-1]])
    last = np.concatenate([gk_sorted[1:] != gk_sorted[:-1], [True]])
    uniq_mask = first & last
    anchors_k = gk_sorted[uniq_mask]
    anchors_pos = order[uniq_mask].astype(np.int64)

    lengths = np.array([len(c) for c in contigs], np.int64)
    rep = AssessReport(
        n_contigs=len(contigs),
        total_length=int(lengths.sum()) if len(lengths) else 0,
        largest=int(lengths.max()) if len(lengths) else 0,
        n50=_nx(lengths, lengths.sum() * 0.5) if len(lengths) else 0,
        ng50=_nx(lengths, G * 0.5),
        genome_length=G,
    )
    covered = np.zeros(G + 1, np.int64)  # difference array
    aligned_total = 0

    for ci, contig in enumerate(contigs):
        c = _CODE[np.frombuffer(contig.encode(), np.uint8)]
        if len(c) < K:
            rep.unaligned_contigs += 1
            rep.per_contig.append({"contig": ci, "aligned": False})
            continue
        ck = _pack_kmers(c)
        cpos = np.arange(len(ck), dtype=np.int64)
        if stride > 1 and len(ck) > 4 * stride:
            sel = np.arange(0, len(ck), stride)
            if sel[-1] != len(ck) - 1:
                sel = np.append(sel, len(ck) - 1)
            ck, cpos = ck[sel], cpos[sel]
        # forward lookups
        ins = np.searchsorted(anchors_k, ck)
        ins = np.minimum(ins, len(anchors_k) - 1)
        hit_f = anchors_k[ins] == ck
        gpos_f = anchors_pos[ins]
        # reverse-complement lookups
        crc = _COMP_CODE[c][::-1]
        ckr = _pack_kmers(crc)
        cposr = np.arange(len(ckr), dtype=np.int64)
        if stride > 1 and len(ckr) > 4 * stride:
            sel = np.arange(0, len(ckr), stride)
            if sel[-1] != len(ckr) - 1:
                sel = np.append(sel, len(ckr) - 1)
            ckr, cposr = ckr[sel], cposr[sel]
        insr = np.minimum(np.searchsorted(anchors_k, ckr),
                          len(anchors_k) - 1)
        hit_r = anchors_k[insr] == ckr
        gpos_r = anchors_pos[insr]

        if hit_f.sum() >= hit_r.sum():
            hits, gpos, cp = hit_f, gpos_f, cpos
        else:
            hits, gpos, cp = hit_r, gpos_r, cposr
        if not hits.any():
            rep.unaligned_contigs += 1
            rep.per_contig.append({"contig": ci, "aligned": False})
            continue
        gp = gpos[hits]
        cpp = cp[hits]
        diag = gp - cpp
        # block breaks: diagonal jumps beyond the relocation threshold
        breaks = np.abs(np.diff(diag)) > relocation_bp
        n_mis = int(breaks.sum())
        rep.misassemblies += n_mis
        # covered genome ranges per colinear block
        block_id = np.concatenate([[0], np.cumsum(breaks)])
        for b in range(n_mis + 1):
            sel = block_id == b
            lo = int(gp[sel].min())
            hi = int(gp[sel].max()) + K
            covered[lo] += 1
            covered[min(hi, G)] -= 1
            aligned_total += hi - lo
        rep.per_contig.append({
            "contig": ci, "aligned": True, "length": int(lengths[ci]),
            "anchors": int(hits.sum()), "misassemblies": n_mis,
        })

    depth = np.cumsum(covered[:-1])
    cov_bases = int((depth > 0).sum())
    rep.genome_fraction = cov_bases / G if G else 0.0
    rep.duplication_ratio = (aligned_total / cov_bases) if cov_bases else 0.0
    return rep
