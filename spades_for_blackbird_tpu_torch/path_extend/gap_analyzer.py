"""Scaffold-join gap analysis.

The port's copy of the JAX package's ``path_extend/gap_analyzer.py``:
host NumPy, as there; it reads no graph.

Counterpart of the reference's GapAnalyzer stack
(modules/path_extend/gap_analyzer.{hpp,cpp}): before a scaffold join is
written with an N run, the estimated gap is checked for an actual
sequence overlap between the tail of the left edge and the head of the
right edge (HammingGapAnalyzer::FixGap, gap_analyzer.cpp:30-83), and
joins whose strongly-negative distance estimate finds NO overlap are
rejected outright (CompositeGapAnalyzer::FixGap, cpp:134-160).  The LA
(local-alignment) joiner is off by default in the reference
(pe_params.info:60 use_la_gap_joiner false), so the Hamming sweep is the
default-parity implementation.

Defaults mirror pe_params.info:62-73 scaffolder options with RL=100:
min_gap_score 0.9, short_overlap 6, basic_overlap_coeff 2.0 (x read
length), max_can_overlap 1.0 (x IS variation), var_coeff 3.0,
artificial_gap 10.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class GapAnalyzerParams:
    min_gap_score: float = 0.9
    short_overlap: int = 6
    basic_overlap: int = 200          # basic_overlap_coeff * read_length
    may_overlap_threshold: int = 75   # max_can_overlap * is_variation
    must_overlap_threshold: int = -225  # -var_coeff * is_variation
    artificial_gap: int = 10
    MIN_OVERLAP_COEFF: float = 0.05


REJECT = object()  # sentinel: the join itself is unreliable


def hamming_fix_gap(seq_a: np.ndarray, seq_b: np.ndarray, est_gap: int,
                    k: int, p: GapAnalyzerParams) -> int | None:
    """Sweep overlap lengths for a high-identity suffix(a)/prefix(b)
    match (HammingGapAnalyzer::FixGap).  Returns the fixed gap as a
    NEGATIVE overlap length, or None when no overlap scores above
    min_gap_score."""
    max_overlap = p.basic_overlap
    if est_gap < 0:
        max_overlap -= est_gap
    max_overlap = min(max_overlap, len(seq_a), len(seq_b))
    min_overlap = 1
    if est_gap < 0:
        min_overlap = max(min_overlap,
                          int(round(p.MIN_OVERLAP_COEFF * -est_gap)))
    best_score = p.min_gap_score
    fixed = None
    for l in range(max_overlap, min_overlap - 1, -1):
        tail = seq_a[len(seq_a) - l:]
        head = seq_b[:l]
        score = 1.0 - float(np.count_nonzero(tail != head)) / l
        if score > best_score:
            best_score = score
            fixed = -l
        if l == p.short_overlap and fixed is not None:
            break  # long overlap found: skip short-overlap noise
    return fixed


def composite_fix_gap(seq_a: np.ndarray, seq_b: np.ndarray, est_gap: int,
                      k: int, p: GapAnalyzerParams | None = None):
    """CompositeGapAnalyzer::FixGap: far-apart gaps pass through, close
    gaps must either reveal an overlap or (when the estimate demands a
    strong overlap that isn't there) the join is rejected (returns
    REJECT); otherwise the gap is clamped up to the artificial N run."""
    if p is None:
        p = GapAnalyzerParams()
    if est_gap > p.may_overlap_threshold:
        return est_gap
    fixed = hamming_fix_gap(seq_a, seq_b, est_gap, k, p)
    if fixed is not None:
        return fixed
    if est_gap < p.must_overlap_threshold:
        return REJECT
    return max(est_gap, p.artificial_gap)
