"""Insert-size estimation from read pairs mapped to a common edge.

PyTorch counterpart of the JAX package's ``paired/insert_size.py``
(the reference's ``InsertSizeCounter``, common/paired_info/
is_counter.hpp, driven at projects/spades/pair_info_count.cpp:186-230):
pairs whose mates map to the same edge give insert-size observations;
the library statistics are the median / MAD / trimmed mean of that
sample. The observations are reduced to a histogram where the mappings
lie (``torch.bincount``, exact); the statistics are the JAX package's
NumPy on that histogram.

Convention: an FR paired-end library with mates (r1, r2) has rc(r2)
mapping downstream of r1 on the same strand; insert size = outer
distance = start(rc r2) + len(r2) - start(r1).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..mapping.mapper import ReadMapping


@dataclass
class InsertSizeStats:
    median: float
    mad: float
    mean: float
    count: int
    # 1% / 99% quantiles (the reference's insert_size_left/right_quantile,
    # library_data.hpp) and the full histogram (insert_size_distribution),
    # consumed by the exSPAnder ideal-pair-info counter
    # (modules/path_extend/ideal_pair_info.hpp:23).
    is_min: int = 0
    is_max: int = 0
    histogram: dict | None = None

    @property
    def deviation(self) -> float:
        """insert_size_deviation analogue: 1.4826 * MAD."""
        return 1.4826 * self.mad


_IS_BINS = 1 << 15  # insert sizes clamp here (32 kb upper bound)


def insert_size_histogram(m1: ReadMapping, m2rc: ReadMapping,
                          len2: torch.Tensor) -> np.ndarray:
    """(_IS_BINS,) int64 host histogram of the insert sizes of pairs whose
    mates map uniquely to one oriented edge (bin 0 stays empty)."""
    len2 = torch.as_tensor(len2).to(m1.start.device, torch.int64)
    ok = m1.mapped & m2rc.mapped & (m1.oriented_edge == m2rc.oriented_edge)
    isz = m2rc.start + len2 - m1.start
    ok &= (isz > 0) & (isz < _IS_BINS)
    return torch.bincount(isz[ok], minlength=_IS_BINS).cpu().numpy()


def estimate_insert_size(m1: ReadMapping, m2rc: ReadMapping,
                         len2) -> InsertSizeStats:
    """m1 = mapping of first mates; m2rc = mapping of REVERSE-COMPLEMENTED
    second mates; len2 = (R,) lengths of second mates. Only the histogram
    crosses to the host; median/MAD/trimmed mean are exact functions of
    it."""
    hist_arr = insert_size_histogram(m1, m2rc, len2).astype(np.int64)
    hist_arr[0] = 0
    total = int(hist_arr.sum())
    if total == 0:
        return InsertSizeStats(0.0, 0.0, 0.0, 0)
    xs = np.arange(_IS_BINS, dtype=np.int64)
    cum = np.cumsum(hist_arr)

    def _quantile(q):
        return int(np.searchsorted(cum, q * total, side="left"))

    med = float(_quantile(0.5))
    # the original sample filter: drop observations >= 10 * median
    cut = int(min(10 * max(med, 1.0), _IS_BINS))
    hist_arr[cut:] = 0
    total = int(hist_arr.sum())
    if total == 0:
        return InsertSizeStats(0.0, 0.0, 0.0, 0)
    cum = np.cumsum(hist_arr)
    med = float(_quantile(0.5))
    dev = np.abs(xs - med)
    order = np.argsort(dev, kind="stable")
    mad_cum = np.cumsum(hist_arr[order])
    mad = float(dev[order][int(np.searchsorted(mad_cum, total / 2,
                                               side="left"))])
    # trimmed mean within 5 MADs (insert_size_refiner.hpp behavior)
    keep = dev <= 5 * max(mad, 1.0)
    kept = hist_arr * keep
    mean = float((kept * xs).sum() / max(kept.sum(), 1))
    hist = {int(v): int(c) for v, c in zip(xs[kept > 0], kept[kept > 0])}
    return InsertSizeStats(med, mad, mean, total,
                           is_min=_quantile(0.01),
                           is_max=_quantile(0.99),
                           histogram=hist)
