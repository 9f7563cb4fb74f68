"""Coverage-model fit: separate erroneous from genomic k-mer coverage.

Copied from the JAX package's ``kmers/coverage_model.py``: the fit
is NumPy and unchanged; only ``count_spectrum_device`` runs on the
device, here with PyTorch. With the time trace on, the fit counts its
likelihood evaluations (``fit_evaluations``: SciPy's ``nfev`` of each
Nelder-Mead call, one an iteration of the mixture's EM), its EM rounds
(``fit_rounds``) and the path that gave its answer (``fit_path.*``).

Stand-in for the reference's mixture-model fit
(assembler/src/common/modules/coverage_model/kmer_coverage_model.cpp:58-310,
zero-truncated error + geometric-skew-normal genomic series optimized with
Nelder-Mead/EM) consumed by GenomicInfoFiller
(common/stages/genomic_info_filler.cpp:31-73). This version extracts the
same outputs (ec_bound, trusted_bound, mean genomic coverage, genome-size
estimate) from the count histogram by valley detection; the full
mixture-model fit is planned to replace the valley heuristic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import timetrace


@dataclass
class GenomicInfo:
    ec_bound: float        # counts <= this are considered erroneous
    trusted_bound: float   # counts >= this are confidently genomic
    mean_coverage: float   # mean genomic k-mer multiplicity
    genome_size: int       # estimated distinct genomic k-mers


# ---------------------------------------------------------------------
# Reference-faithful mixture fit (kmer_coverage_model.cpp:58-310):
# zero-truncated generalized-Pareto error component + zeta-weighted
# skew-normal genomic copy series (copies 1..10), EM over the error
# probability with Nelder-Mead maximization of the complete-data
# log-likelihood inside each EM step.
# ---------------------------------------------------------------------

_MAX_COPY = 10


def _smooth_3rs3r(y: np.ndarray) -> np.ndarray:
    """Tukey 3RS3R-style running-median smoothing (math/smooth.hpp
    Smooth3RS3R): repeated median-of-3 to fixpoint, twice."""
    y = np.asarray(y, dtype=np.float64).copy()
    if len(y) < 3:
        return y
    for _ in range(2):
        for _ in range(30):
            m = y.copy()
            m[1:-1] = np.median(
                np.stack([y[:-2], y[1:-1], y[2:]]), axis=0)
            if np.array_equal(m, y):
                break
            y = m
    return y


def _perr(i: np.ndarray, scale: float, shape: float) -> np.ndarray:
    """Discrete generalized-Pareto error pmf over multiplicities
    (kmer_coverage_model.cpp:40-43)."""
    with np.errstate(all="ignore"):
        a = np.power(1.0 + shape * (i - 1.0) / scale, -1.0 / shape)
        b = np.power(1.0 + shape * i / scale, -1.0 / shape)
    return np.maximum(a - b, 1e-300)


def _dzeta(copies: np.ndarray, p: float) -> np.ndarray:
    """Zeta-distribution copy-number prior (cpp:36-38)."""
    from scipy.special import zeta
    return np.power(copies, -p - 1.0) / zeta(p + 1.0)


_SQRT_2PI = np.sqrt(2.0 * np.pi)


def _pgood(i: np.ndarray, zp: float, u: float, sd: float,
           shape2: float) -> np.ndarray:
    """Copy-series density: sum over copy c of dzeta(c, zp) *
    skew_normal(c*u, sd*sqrt(c), shape2).pdf(i) (cpp:45-56)."""
    copies = np.arange(1, _MAX_COPY + 1, dtype=np.float64)
    mix = _dzeta(copies, zp)
    # vectorized over (copies, bins)
    scales = sd * np.sqrt(copies)
    t = (i[None, :] - (copies * u)[:, None]) / scales[:, None]
    from scipy.special import ndtr
    pdf = (2.0 / scales[:, None]) * np.exp(-0.5 * t * t) / _SQRT_2PI \
        * ndtr(shape2 * t)
    res = (mix[:, None] * pdf).sum(axis=0)
    return np.maximum(res, 1e-300)


def _em_loglike(x, hist, z, xs):
    """CovModelLogLikeEM (cpp:99-147), negated for minimization."""
    zp, shape, u, sd, scale, shape2 = x
    if (zp <= 1 or shape <= 0 or sd <= 0 or u <= 0 or scale <= 0
            or not np.all(np.isfinite(x))):
        return np.inf
    le = np.log(_perr(xs, scale, shape))
    lg = np.log(_pgood(xs, zp, u, sd, shape2))
    lg = np.where(np.isfinite(lg), lg, -1000.0)
    res = np.sum(hist * (z * le + (1.0 - z) * lg))
    return -res if np.isfinite(res) else np.inf


def _e_step(x, p, xs):
    zp, shape, u, sd, scale, shape2 = x
    pe = p * _perr(xs, scale, shape)
    z = pe / (pe + (1 - p) * _pgood(xs, zp, u, sd, shape2))
    return np.where(np.isfinite(z), z, 1.0)


def fit_reference_model_hist(bc: np.ndarray,
                             probability_threshold: float = 0.05,
                             strong_probability_threshold: float = 0.999
                             ) -> GenomicInfo | None:
    """The full KMerCoverageModel::Fit flow (cpp:186-377): valley
    detection on the smoothed histogram, median/MAD coverage init, EM
    over the error fraction with Nelder-Mead over the 6 density params,
    posterior-based threshold deduction, genome-size estimate.
    ``bc[c]`` = number of distinct k-mers with multiplicity c (the
    spectrum — the only statistic the whole fit consumes, so callers on
    slow device->host links transfer the few-KB histogram instead of
    the raw counts column).  Returns None when the fit fails to
    converge (callers fall back, genomic_info_filler.cpp:56-62)."""
    from scipy.optimize import minimize

    bc = np.asarray(bc, dtype=np.int64)
    if bc.sum() - (bc[0] if len(bc) else 0) < 100:
        return None
    # hist[i] = # distinct k-mers with multiplicity i+1
    bc = bc[1:]
    if len(bc) <= 10:
        return None
    hist = bc.astype(np.float64)

    # EstimateValley (cpp:168-184): first minimum of the smoothed hist
    scov = _smooth_3rs3r(hist)
    valley = 0
    idx = 1
    while idx < len(scov) and scov[idx] < scov[valley]:
        valley = idx
        idx += 1

    # first max after the valley, refined via median (cpp:192-221)
    max_cov = valley + 1 + int(np.argmax(hist[valley + 1:]))
    second_valley = min(2 * max_cov - valley, len(hist))
    after_valley = hist[valley + 1:second_valley].sum()
    ccov = 0.0
    for i in range(valley + 1, second_valley):
        if ccov > after_valley / 2:
            max_cov = max(i, max_cov)
            break
        ccov += hist[i]

    # MAD around the peak (cpp:223-240)
    mvals = [hist[max_cov] if max_cov < len(hist) else 0.0]
    for i in range(1, min(max_cov - valley, len(hist) - max_cov)):
        mvals.append(hist[max_cov + i] + hist[max_cov - i])
    tmad = float(np.sum(mvals))
    cov_sd = np.sqrt(5.0 * max_cov)
    madcov = 0.0
    for i in range(min(len(mvals), max_cov - valley)):
        if madcov > tmad / 2:
            cov_sd = float(i)
            break
        madcov += mvals[i]
    cov_sd *= 1.4826

    total = hist.sum()
    err_prob = float(hist[:valley + 1].sum() / total)
    err_prob = min(max(err_prob, 1e-3), 1 - 1e-3)

    x = np.array([3.0, 3.0, float(max_cov), max(cov_sd, 1.0), 1.0, 0.0])
    good_n = min(len(hist), 5 * _MAX_COPY * max_cov // 4)
    ghist = hist[:good_n]
    xs = np.arange(1, good_n + 1, dtype=np.float64)

    prev = 2.0
    it = 1
    while abs(prev - err_prob) > 1e-8 and it < 60:
        z = _e_step(x, err_prob, xs)
        prev = err_prob
        err_prob = float(np.sum(z * ghist) / total)
        last = abs(prev - err_prob) <= 1e-8
        r = minimize(_em_loglike, x, args=(ghist, z, xs),
                     method="Nelder-Mead",
                     options={"maxiter": (2000 if last
                                          else 5 * 6 * it * 4),
                              "xatol": 1e-8, "fatol": 1e-8})
        timetrace.count("fit_rounds")
        timetrace.count("fit_evaluations", int(r.nfev))
        x = r.x
        it += 1

    zp, shape, u, sd, scale, shape2 = x
    delta = shape2 / np.sqrt(1 + shape2 * shape2)
    mean_coverage = u + sd * delta * np.sqrt(2 / np.pi)
    converged = bool(np.all(np.isfinite(x)) and np.isfinite(err_prob))

    if converged and valley > u and u > 2:
        valley = int(round(u / 2.0))

    low_threshold = 1
    error_threshold = 0
    if converged:
        z = _e_step(x, err_prob, xs)
        converged = False
        for i in range(len(z)):
            if z[i] > strong_probability_threshold:
                low_threshold = min(i + 1, valley)
            elif z[i] < probability_threshold:
                error_threshold = max(i + 1, valley)
                converged = True
                break
    if not converged:
        return None
    error_threshold = (min(valley + (int(mean_coverage) - valley) // 2,
                           error_threshold)
                       if valley < mean_coverage else valley)
    genome_size = int(ghist[max(error_threshold - 1, 0):].sum()) // 2
    return GenomicInfo(
        ec_bound=float(error_threshold),
        trusted_bound=float(low_threshold),
        mean_coverage=float(mean_coverage),
        genome_size=genome_size,
    )


def _nbinom_logpmf(x, mean, disp):
    """Negative binomial log-pmf parameterized by mean and dispersion r."""
    from math import lgamma
    r = disp
    p = r / (r + mean)
    x = np.asarray(x, dtype=np.float64)
    lg = np.vectorize(lgamma)
    return (lg(x + r) - lg(r) - lg(x + 1) + r * np.log(p)
            + x * np.log1p(-p))


def fit_mixture_hist(bc: np.ndarray, max_count: int = 512,
                     iters: int = 40) -> GenomicInfo | None:
    """EM fit of a two-component mixture on the count spectrum ``bc[c]``:
    errors ~ geometric (zero-truncated), genomic ~ negative binomial.

    The principled replacement for the valley heuristic, standing in for
    the reference's zero-truncated + geometric-skew-normal mixture
    optimized with Nelder-Mead/EM (kmer_coverage_model.cpp:58-310).
    Returns None when the fit degenerates (uneven coverage) — callers
    fall back to the valley estimate like genomic_info_filler.cpp:60.
    """
    bc = np.asarray(bc, dtype=np.int64)
    bc_full = bc
    if len(bc) > max_count + 1:
        clipped = bc[:max_count + 1].copy()
        clipped[max_count] += bc[max_count + 1:].sum()
        bc = clipped
    hist = bc.astype(np.float64)
    xs = np.arange(len(hist), dtype=np.float64)
    w = hist.copy()
    if len(w):
        w[0] = 0.0
    total = w.sum()
    if total < 100:
        return None

    # init: error geometric p from low counts, genomic mean from the
    # high-count mass
    peak = 3 + int(np.argmax(hist[3:])) if len(hist) > 4 else 2
    gmean = max(float(peak), 4.0)
    gdisp = 10.0
    p_err = 0.5
    pi_err = 0.5
    xs_safe = np.maximum(xs, 1.0)
    for _ in range(iters):
        timetrace.count("fit_rounds")
        timetrace.count("fit_evaluations")
        # E step (zero-truncated geometric pmf: p (1-p)^(x-1))
        log_err = np.log(p_err) + (xs_safe - 1) * np.log1p(-p_err)
        log_gen = _nbinom_logpmf(xs_safe, gmean, gdisp)
        le = np.log(max(pi_err, 1e-12)) + log_err
        lg_ = np.log(max(1 - pi_err, 1e-12)) + log_gen
        m = np.maximum(le, lg_)
        denom = m + np.log(np.exp(le - m) + np.exp(lg_ - m))
        resp_err = np.exp(le - denom)
        # M step
        we = w * resp_err
        wg = w * (1 - resp_err)
        if we.sum() <= 0 or wg.sum() <= 0:
            return None
        pi_err = we.sum() / total
        mean_err = (we * xs).sum() / we.sum()
        p_err = min(max(1.0 / max(mean_err, 1.0 + 1e-6), 1e-4), 0.999)
        gmean = (wg * xs).sum() / wg.sum()
        var_g = (wg * (xs - gmean) ** 2).sum() / wg.sum()
        if var_g > gmean * 1.05:
            gdisp = gmean ** 2 / (var_g - gmean)
        gdisp = min(max(gdisp, 0.5), 1e4)

    if gmean < 3.0 or not np.isfinite(gmean):
        return None  # no separated genomic peak: uneven coverage
    # ec bound: first count where genomic posterior dominates
    log_err = np.log(p_err) + (xs_safe - 1) * np.log1p(-p_err)
    log_gen = _nbinom_logpmf(xs_safe, gmean, gdisp)
    err_dom = (np.log(max(pi_err, 1e-12)) + log_err >
               np.log(max(1 - pi_err, 1e-12)) + log_gen)
    cross = 1
    for c in range(1, int(gmean) + 1):
        if c < len(err_dom) and err_dom[c]:
            cross = c
    tail = bc_full[cross + 1:]
    n_genomic = int(tail.sum())
    if n_genomic == 0:
        return None
    tail_xs = np.arange(cross + 1, len(bc_full), dtype=np.float64)
    return GenomicInfo(
        ec_bound=float(cross),
        trusted_bound=float(min(gmean / 2.0, cross * 2 + 1)),
        mean_coverage=float((tail * tail_xs).sum() / n_genomic),
        genome_size=n_genomic,
    )


HIST_BINS = 4096  # spectrum resolution kept on-device (counts clamp here)


def count_spectrum_device(counts, num, bins: int = HIST_BINS) -> np.ndarray:
    """Count spectrum (bc[c] = distinct k-mers with count c) computed on
    the counts' device with ``torch.bincount``, so only ``bins`` ints
    cross to the host. Pass the result to ``fit_coverage_model_hist``."""
    import torch

    rows = torch.arange(counts.shape[0], device=counts.device)
    valid = (rows < num) & (counts > 0)
    idx = torch.clamp(counts.to(torch.int64), 0, bins - 1)[valid]
    return torch.bincount(idx, minlength=bins).cpu().numpy().astype(np.int64)


def fit_coverage_model_hist(bc: np.ndarray) -> GenomicInfo:
    """Fit from the count spectrum ``bc[c]`` (bin 0 ignored)."""
    bc = np.asarray(bc, dtype=np.int64)
    if len(bc):
        bc = bc.copy()
        bc[0] = 0
    total = int(bc.sum())
    if total == 0:
        return GenomicInfo(0.0, 0.0, 0.0, 0)
    try:
        fitted = fit_reference_model_hist(bc)
    except Exception:
        fitted = None  # scipy edge cases: fall through like !converged_
    if fitted is not None:
        timetrace.count("fit_path.reference")
        return fitted
    fitted = fit_mixture_hist(bc)
    if fitted is not None:
        timetrace.count("fit_path.mixture")
        return fitted
    # valley fallback (uneven coverage / tiny samples)
    timetrace.count("fit_path.valley")
    hist = bc[:257].copy()
    if len(bc) > 257:
        hist[-1] += bc[257:].sum()
    hist = np.append(hist, np.zeros(max(0, 4 - len(hist)), np.int64))
    # valley: minimum of the histogram between the error head and the
    # genomic peak (the mixture components' crossing point)
    peak = 3 + int(np.argmax(hist[3:])) if len(hist) > 3 else 1
    if peak <= 3:
        valley = 1
    else:
        # take the median index of the minimum plateau: low-error data has
        # a wide zero run between error head and genomic peak, and the
        # separation bound belongs mid-run, not at the first zero
        region = hist[1:peak]
        min_idxs = np.nonzero(region == region.min())[0]
        valley = 1 + int(min_idxs[len(min_idxs) // 2])
    xs_full = np.arange(len(bc), dtype=np.float64)
    tail = bc[valley + 1:]
    n_genomic = int(tail.sum())
    if n_genomic == 0:
        # uneven coverage fallback (the reference falls back to
        # ErroneousConnectionThresholdFinder, genomic_info_filler.cpp:60)
        mean_all = float((bc * xs_full).sum() / total)
        return GenomicInfo(float(valley), float(valley + 1),
                           mean_all, total)
    mean_cov = float((tail * xs_full[valley + 1:]).sum() / n_genomic)
    return GenomicInfo(
        ec_bound=float(valley),
        trusted_bound=float(min(mean_cov / 2.0, valley * 2 + 1)),
        mean_coverage=mean_cov,
        genome_size=n_genomic,
    )
