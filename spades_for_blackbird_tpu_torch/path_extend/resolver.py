"""Repeat resolution: paired-info-guided path extension (exSPAnder).

The port's copy of the JAX package's ``path_extend/resolver.py``:
host NumPy, as there; a graph on the card is copied to the host once,
at the top of each pass (``graph/host.host_view``).

Counterpart of the reference's path_extend module
(modules/path_extend/pipeline/launcher.cpp:599 ``PathExtendLauncher``,
``CompositeExtender::GrowAllPaths`` at path_extenders.cpp:32-75), with the
full scoring stack ported faithfully:

- ``IdealPairInfo``   — closed-form expected pair count for an edge pair
  at a distance under the library's insert-size distribution
  (ideal_pair_info.hpp:23-95 ``IdealPairInfoCounter``);
- ``PairedLib``       — clustered-index lookups with a distance window
  (paired_library.hpp:122 ``CountPairedInfo``);
- ``PathCoverWeightCounter`` — per-path-edge actual/ideal normalization,
  the 2.9 raw-weight cutoff, single_threshold gating and the
  lib_weight / total_ideal final score (weight_counter.hpp:217-310) with
  the GlobalCoverageAwareIdealInfoProvider correction
  (weight_counter.hpp:313-360, MAGIC_COEFF 2);
- ``SimpleExtensionChooser`` — trivial/bulge path-suffix exclusion
  (extension_chooser.hpp:43-87 PathAnalyzer), no-ideal-info exclusion and
  all-candidate-ambiguity exclusion (:499-540), priority_coeff candidate
  filtering (:416-470 ExcludingExtensionChooser);
- UsedUniqueStorage gating, suffix-prefix overlap trimming
  (overlap_remover.hpp:77) and containment dedup
  (path_deduplicator.hpp:15).

The hot data (read mapping, paired histograms) is produced on device
(mapping/, paired/); the extension *control loop* walks the simplified
graph — thousands of edges, not millions — on the host with vectorized
(searchsorted) index lookups, exactly where the reference itself is
serial (path_extenders.cpp:32).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..graph.host import GraphView, edge_mask, host_view
from ..ops import dna
from ..utils.logger import get_logger


@dataclass
class PEParams:
    """extension_options (configs/debruijn/pe_params.info:31-38)."""
    single_threshold: float = 0.1     # normalized per-edge support gate
    weight_threshold: float = 0.5     # min final score to extend
    priority_coeff: float = 1.5       # best/competitor separation
    raw_weight_cutoff: float = 2.9    # weight_counter.hpp:251 hard floor
    unique_edge_length: int = 300     # "long unique" edges claimable once
    seed_min_length: int = 0          # seeds = all edges (pe_resolver.cpp:50)
    max_path_edges: int = 10000
    max_junction_visits: int = 8      # short-loop guard


@dataclass
class PathSet:
    """Resolved paths: each a list of edge ids; gaps currently 0."""
    paths: list[list[int]] = field(default_factory=list)


class IdealPairInfo:
    """IdealPairInfoCounter (ideal_pair_info.hpp:23): expected number of
    read-pair placements supporting (e1, e2, dist), averaged over the
    insert-size distribution. Lengths/distances in k-mers."""

    def __init__(self, is_histogram: dict[int, int], read_length: int,
                 k: int, d_min: int, d_max: int):
        self.rs = int(read_length)
        self.k = int(k)
        total = sum(is_histogram.values()) or 1
        self.dist = [(int(i), c / total) for i, c in
                     sorted(is_histogram.items())
                     if max(d_min, 0) <= i <= d_max and c > 0]
        self._memo: dict[tuple[int, int, int], float] = {}

    def _ideal_reads(self, len1: int, len2: int, dist: int,
                     insert: int) -> float:
        # ideal_pair_info.hpp:62 IdealReads (non-additive form)
        k, rs = self.k, self.rs
        if dist == 0:
            return max(len1 - insert + 2 * rs - 2 - k + 1, 0)
        if dist < 0:
            len1, len2 = len2, len1
            dist = -dist
        gap_len = dist - len1
        right = min(insert - rs - 1, gap_len + len2 - 1)
        left = max(gap_len + k + 1 - rs, insert - rs - len1 - rs + k + 1)
        return max(right - left + 1, 0)

    def __call__(self, len1: int, len2: int, dist: int) -> float:
        key = (len1, len2, dist)
        v = self._memo.get(key)
        if v is None:
            v = sum(p * self._ideal_reads(len1, len2, dist, i)
                    for i, p in self.dist)
            self._memo[key] = v
        return v


class PairedLib:
    """Clustered paired index + library stats with vectorized lookups
    (PairedInfoLibrary, paired_library.hpp:30)."""

    def __init__(self, clustered, is_stats, read_length: int, k: int,
                 lib_coverage: float | None = None,
                 conj: np.ndarray | None = None,
                 len_k: np.ndarray | None = None):
        n = int(clustered.num)
        e1 = np.asarray(clustered.e1)[:n].astype(np.int64)
        e2 = np.asarray(clustered.e2)[:n].astype(np.int64)
        d = np.asarray(clustered.dist)[:n].astype(np.int64)
        w = np.asarray(clustered.weight)[:n].astype(np.float64)
        cvar = getattr(clustered, "var", None)
        v = (np.asarray(cvar)[:n].astype(np.float64)
             if cvar is not None else np.zeros(n, np.float64))
        if conj is not None and len_k is not None:
            # conjugate symmetrization (the reference's half-storage
            # mirroring, paired_info.hpp:24-120): a point (e1, e2, d)
            # implies (conj(e2), conj(e1), d + len(e2) - len(e1)), so
            # paths grown in the conjugate orientation see the same
            # evidence.
            conj = np.asarray(conj).astype(np.int64)
            ln = np.asarray(len_k).astype(np.int64)
            ce1 = 2 * conj[e2 // 2] + (e2 & 1)
            ce2 = 2 * conj[e1 // 2] + (e1 & 1)
            cd = d + ln[e2 // 2] - ln[e1 // 2]
            e1 = np.concatenate([e1, ce1])
            e2 = np.concatenate([e2, ce2])
            d = np.concatenate([d, cd])
            w = np.concatenate([w, w])
            v = np.concatenate([v, v])
            # drop duplicates (self-conjugate pairs mirror onto themselves)
            key_all = np.stack([e1, e2, d], axis=1)
            _, idx_u = np.unique(key_all, axis=0, return_index=True)
            e1, e2, d, w, v = (e1[idx_u], e2[idx_u], d[idx_u], w[idx_u],
                               v[idx_u])
        self.d = d
        self.w = w
        key = (e1 << 31) | e2
        order = np.argsort(key, kind="stable")
        self.key = key[order]
        self.d = self.d[order]
        self.w = self.w[order]
        # per-point distance spread (index_point.hpp PointT.var)
        self.sd = np.sqrt(v[order])
        self.read_length = int(read_length)
        self.k = int(k)
        med = float(getattr(is_stats, "median", 0.0) or 0.0)
        mad = float(getattr(is_stats, "mad", 0.0) or 0.0)
        self.is_med = med
        self.is_var = max(1.4826 * mad, 5.0)
        self.is_min = int(getattr(is_stats, "is_min", 0) or
                          max(med - 3 * self.is_var, 0))
        self.is_max = int(getattr(is_stats, "is_max", 0) or
                          (med + 3 * self.is_var))
        hist = getattr(is_stats, "histogram", None)
        if not hist:
            hist = {int(round(med)): 1} if med > 0 else {200: 1}
        self.ideal = IdealPairInfo(
            hist, read_length, k,
            d_min=-int(med), d_max=self.is_max + 1)
        self.lib_coverage = lib_coverage

    def points(self, o1: int, o2: int):
        key = (np.int64(o1) << 31) | np.int64(o2)
        lo = np.searchsorted(self.key, key, side="left")
        hi = np.searchsorted(self.key, key, side="right")
        return self.d[lo:hi], self.w[lo:hi], self.sd[lo:hi]

    def count_paired_info(self, o1: int, o2: int, dist: int) -> float:
        """Sum of point weights around ``dist`` within the library
        variation window (paired_library.hpp:122), widened per point by
        its clustered-distance spread — the reference's point variance
        (index_point.hpp:244 widens merge bounds by +-var)."""
        d, w, sd = self.points(o1, o2)
        if len(d) == 0:
            return 0.0
        dev = np.maximum(int(self.is_var), 5) + sd
        sel = (d >= dist - dev) & (d <= dist + dev)
        return float(w[sel].sum())


class PathCoverWeightCounter:
    """weight_counter.hpp:217 PathCoverWeightCounter with the
    GlobalCoverageAware ideal correction (:313-360)."""
    MAGIC_COEFF = 2.0

    def __init__(self, lib: PairedLib, single_threshold: float,
                 raw_weight_cutoff: float, len_k, lib_coverage: float):
        self.lib = lib
        self.single_threshold = single_threshold
        self.raw_cutoff = raw_weight_cutoff
        self.len_k = len_k  # (E,) k-mer lengths array
        rl, k = lib.read_length, lib.k
        self.correction = (lib_coverage / ((rl - k) * self.MAGIC_COEFF)
                           if rl > k else lib_coverage)

    def find_covered(self, path: list[int], cand: int, gap: int = 0
                     ) -> list[tuple[int, float]]:
        """BasicIdealInfoProvider::FindCoveredEdges (weight_counter.hpp:
        113) scaled by the coverage correction: (path index, ideal)."""
        out = []
        acc = gap
        lc = int(self.len_k[cand])
        for i in range(len(path) - 1, -1, -1):
            lp = int(self.len_k[path[i]])
            acc += lp
            if acc - lp > self.lib.is_max:
                break
            w = self.lib.ideal(lp, lc, acc)
            if w > 0:
                out.append((i, w * self.correction))
        return out

    def _count_lib(self, path, cand, covered, gap):
        out = []
        acc_by_i = {}
        acc = gap
        for i in range(len(path) - 1, -1, -1):
            acc += int(self.len_k[path[i]])
            acc_by_i[i] = acc
        for i, ideal_w in covered:
            actual = self.lib.count_paired_info(
                2 * path[i], 2 * cand, acc_by_i[i])
            if actual < self.raw_cutoff:
                actual = 0.0
            if ideal_w > 0 and actual / ideal_w >= self.single_threshold:
                out.append((i, ideal_w))
        return out

    def count_weight(self, path, cand, excluded: set[int],
                     gap: int = 0) -> float:
        covered = self.find_covered(path, cand, gap)
        lib_weight = sum(w for i, w in self._count_lib(
            path, cand, covered, gap) if i not in excluded)
        total_ideal = sum(w for i, w in covered if i not in excluded)
        return lib_weight / total_ideal if total_ideal > 0 else 0.0

    def pair_info_exist(self, path, cand, gap: int = 0) -> set[int]:
        covered = self.find_covered(path, cand, gap)
        return {i for i, w in self._count_lib(path, cand, covered, gap)
                if w > 0}


class SimpleChooser:
    """SimpleExtensionChooser (extension_chooser.hpp:499) on top of
    ExcludingExtensionChooser (:416)."""

    def __init__(self, wc: PathCoverWeightCounter, weight_threshold: float,
                 priority_coeff: float, in_edges, start_v, end_v, len_k):
        self.wc = wc
        self.weight_threshold = weight_threshold
        self.priority = priority_coeff
        self.in_edges = in_edges      # dict v -> [edges]
        self.start_v = start_v
        self.end_v = end_v
        self.len_k = len_k

    def _exclude_trivial_with_bulges(self, path: list[int]) -> set[int]:
        """PathAnalyzer::ExcludeTrivialWithBulges (extension_chooser.hpp:
        59): walk back from the junction through unique-incoming vertices
        and simple bulges — those path edges precede EVERY genomic copy
        of the junction, so their pair info cannot discriminate."""
        excl: set[int] = set()
        idx = len(path) - 1
        while idx >= 0:
            # ExcludeTrivial leg
            v = int(self.end_v[path[idx]])
            while idx >= 0 and len(self.in_edges.get(v, [])) == 1:
                excl.add(idx)
                v = int(self.start_v[path[idx]])
                idx -= 1
            if idx < 0:
                break
            # bulge leg: all in-edges of the stop vertex from one vertex
            v = int(self.end_v[path[idx]])
            u = int(self.start_v[path[idx]])
            ins = self.in_edges.get(v, [])
            if ins and all(int(self.start_v[e]) == u for e in ins):
                excl.add(idx)
                idx -= 1
            else:
                break
        return excl

    def filter(self, path: list[int], cands: list[int]
               ) -> list[int]:
        if not cands:
            return []
        to_exclude = self._exclude_trivial_with_bulges(path)
        if len(cands) >= 2:
            # exclusion on absence of ideal info (extension_chooser.hpp:
            # 505-520): a path edge too far for SOME candidate is unfair
            # evidence
            covered_sets = []
            for c in cands:
                covered_sets.append(
                    {i for i, w in self.wc.find_covered(path, c)})
            for i in range(len(path)):
                if i in to_exclude:
                    continue
                if any(i not in cs for cs in covered_sets):
                    to_exclude.add(i)
            # exclusion on all-candidate support (repeat evidence,
            # extension_chooser.hpp:523-538)
            cnt: dict[int, int] = {}
            for c in cands:
                for i in self.wc.pair_info_exist(path, c):
                    cnt[i] = cnt.get(i, 0) + 1
            for i, c in cnt.items():
                if c == len(cands):
                    to_exclude.add(i)
        weights = {c: self.wc.count_weight(path, c, to_exclude)
                   for c in cands}
        max_w = max(weights.values())
        if max_w < self.weight_threshold:
            return []
        return [c for c in cands if weights[c] >= max_w / self.priority]


class LongReadChooser:
    """LongReadsExtensionChooser (extension_chooser.hpp:1108-1210):
    long-read graph paths vote for the next edge.  A supporting path
    must contain the grown path's last edge with a matching backward
    prefix (EqualBegins); the edge it continues with accumulates the
    read weight.  Primary votes additionally require a UNIQUE edge in
    the read's matched back context (UniqueBackPath with the
    LongReadsUniqueEdgeAnalyzer, extension_chooser.hpp:1145-1160) — a
    read whose context is all collapsed repeats cannot tell WHICH copy
    it saw.  Candidates pass when their weight exceeds the filtering
    threshold (with the reference's single-variant >= 2 fallback), and
    the best must dominate by ``weight_priority`` for an unambiguous
    choice."""

    def __init__(self, read_paths: list[tuple[list[int], float]],
                 conj, uniq_mask=None, filtering_threshold: float = 2.0,
                 weight_priority: float = 10.0):
        agg: dict[tuple, float] = {}
        conj = np.asarray(conj)
        for p, w in read_paths:
            if len(p) < 2:
                continue
            agg[tuple(p)] = agg.get(tuple(p), 0.0) + w
            rcp = tuple(int(conj[e]) for e in reversed(p))
            agg[rcp] = agg.get(rcp, 0.0) + w
        self.paths = list(agg.items())
        self.index: dict[int, list[tuple[int, int]]] = {}
        for pi, (p, _w) in enumerate(self.paths):
            for pos, e in enumerate(p):
                self.index.setdefault(int(e), []).append((pi, pos))
        self.filtering_threshold = filtering_threshold
        self.weight_priority = weight_priority
        self.uniq_mask = uniq_mask

    def _equal_begins(self, path: list[int], p: tuple, pos: int) -> bool:
        j, i = len(path) - 1, pos
        while j >= 0 and i >= 0:
            if path[j] != p[i]:
                return False
            j -= 1
            i -= 1
        return True

    def filter(self, path: list[int], cands: list[int]) -> list[int]:
        if not cands or not self.paths:
            return []
        back = int(path[-1])
        weights: dict[int, float] = {}
        raw: dict[int, float] = {}
        for pi, pos in self.index.get(back, []):
            p, w = self.paths[pi]
            if pos + 1 >= len(p):
                continue
            if not self._equal_begins(path, p, pos):
                continue
            nxt = int(p[pos + 1])
            raw[nxt] = raw.get(nxt, 0.0) + w
            if self.uniq_mask is not None and not any(
                    self.uniq_mask[int(e)] for e in p[:pos + 1]):
                continue  # UniqueBackPath: ambiguous repeat-only context
            weights[nxt] = weights.get(nxt, 0.0) + w
        cw = {c: weights.get(int(c), 0.0) for c in cands}
        strong = [c for c in cands if cw[c] > self.filtering_threshold]
        if not strong:
            # single-variant fallback over UNFILTERED support
            # (extension_chooser.hpp:1166-1186 next_variants)
            nz = [c for c in cands if raw.get(int(c), 0.0) > 0]
            if len(nz) == 1 and raw[int(nz[0])] >= 2:
                strong = nz
            else:
                return []
        strong.sort(key=lambda c: -cw[c])
        if len(strong) > 1 and \
                cw[strong[0]] > self.weight_priority * cw[strong[1]]:
            strong = strong[:1]
        return strong


_log = get_logger("PathExtend")


def _adjacency(g: GraphView):
    g = host_view(g)
    alive = np.asarray(edge_mask(g))
    start_v = np.asarray(g.start_v)
    end_v = np.asarray(g.end_v)
    out_of: dict[int, list[int]] = {}
    in_of: dict[int, list[int]] = {}
    for e in np.nonzero(alive)[0]:
        out_of.setdefault(int(start_v[e]), []).append(int(e))
        in_of.setdefault(int(end_v[e]), []).append(int(e))
    return alive, start_v, end_v, out_of, in_of


def estimate_lib_coverage(g: GraphView) -> float:
    """Length-weighted average coverage over the longest edges
    (LaunchSupport::EstimateLibCoverage analogue)."""
    g = host_view(g)
    alive = np.asarray(edge_mask(g))
    lens = np.asarray(g.seq_len)[alive].astype(np.float64)
    covs = np.asarray(g.cov)[alive].astype(np.float64)
    if lens.size == 0:
        return 1.0
    order = np.argsort(-lens)
    lens, covs = lens[order], covs[order]
    take = max(1, int(np.searchsorted(np.cumsum(lens), lens.sum() * 0.5)
                      ) + 1)
    sel = slice(0, take)
    return float((covs[sel] * lens[sel]).sum() / lens[sel].sum())


@dataclass
class LibSpec:
    """One paired library's inputs to repeat resolution (the per-lib
    model of pair_info_count.cpp:186-230 + library.hpp): a clustered
    paired index, its own insert-size stats, read length and kind."""
    clustered: object
    is_stats: object = None
    read_length: int | None = None
    kind: str = "pe"            # "pe" | "mp" | "long"
    coverage_share: float = 1.0  # this lib's fraction of total coverage
    # kind == "long": aligned long-read edge paths [(path, weight)]
    # (the PathStorage input of LongReadsExtensionChooser)
    read_paths: list | None = None


def resolve_paths(g: GraphView, paired, params: PEParams | None = None,
                  is_stats=None, read_length: int | None = None,
                  lib_coverage: float | None = None) -> PathSet:
    """Grow seed paths using a clustered PairedIndex ``paired``.

    ``paired`` entries use *oriented edge ids* (2*edge + rc-bit) with
    distances = start-to-start offsets (paired/pair_info.py convention).
    ``is_stats``/``read_length`` feed the ideal-pair-info machinery; when
    omitted, conservative defaults are derived from the graph.
    """
    g = host_view(g)
    return resolve_paths_multi(
        g, [LibSpec(paired, is_stats, read_length)], params=params,
        lib_coverage=lib_coverage)


def resolve_paths_multi(g: GraphView, lib_specs: list[LibSpec],
                        params: PEParams | None = None,
                        lib_coverage: float | None = None) -> PathSet:
    """Multi-library exSPAnder: one extension chooser per library, tried
    in PE-first order at every growth step (the CompositeExtender
    round-robin, path_extender.hpp:426 + extenders_logic.cpp:462
    MakeBasicExtenders building per-lib extenders; MP extenders come
    after the basic ones, extenders_logic.cpp:388)."""
    g = host_view(g)
    if params is None:
        params = PEParams()
    alive, start_v, end_v, out_of, in_of = _adjacency(g)
    conj = np.asarray(g.conj)
    seq_len = np.asarray(g.seq_len)
    k = g.k
    len_k = (seq_len - k).astype(np.int64)

    if lib_coverage is None:
        lib_coverage = estimate_lib_coverage(g)
    # long-read extenders first, then PE, then MP (MakeBasicExtenders
    # ordering, extenders_logic.cpp:462-520)
    _ORDER = {"long": 0, "pe": 1, "mp": 2}
    specs = sorted(lib_specs, key=lambda s: _ORDER.get(s.kind, 1))
    from . import unique_edges as _ue
    choosers = []
    for spec in specs:
        if spec.kind == "long":
            choosers.append(LongReadChooser(
                spec.read_paths or [], conj,
                uniq_mask=_ue.unique_edge_mask(
                    g, params.unique_edge_length)))
            continue
        rl = spec.read_length or max(k + 1, 100)
        cov = lib_coverage * spec.coverage_share
        lib = PairedLib(spec.clustered, spec.is_stats, rl, k,
                        lib_coverage=cov, conj=conj, len_k=len_k)
        wc = PathCoverWeightCounter(lib, params.single_threshold,
                                    params.raw_weight_cutoff, len_k, cov)
        choosers.append(SimpleChooser(wc, params.weight_threshold,
                                      params.priority_coeff, in_of,
                                      start_v, end_v, len_k))

    # seeds: long edges first (SortByLength, pe_resolver.cpp)
    seeds = [int(e) for e in np.nonzero(alive)[0]
             if seq_len[e] >= params.seed_min_length]
    seeds.sort(key=lambda e: -int(seq_len[e]))

    # uniqueness + multiplicity gating (ScaffoldingUniqueEdgeAnalyzer,
    # scaff_supplementary.cpp:30-62): edges passing the length+coverage
    # uniqueness test are claimed once (UsedUniqueStorage); long edges
    # FAILING the coverage window are collapsed repeats — they allow up
    # to round(cov/median) traversals instead of being claimed
    from . import unique_edges as _ue
    uniq_mask = _ue.unique_edge_mask(g, params.unique_edge_length)
    multiplicity = _ue.edge_multiplicity(g, params.unique_edge_length)
    uses: dict[int, int] = {}
    paths: list[list[int]] = []
    seeded: set[int] = set()

    def _uses(c: int) -> int:
        return uses.get(c, 0) + uses.get(int(conj[c]), 0)

    def usable(c: int) -> bool:
        if seq_len[c] < params.unique_edge_length:
            return True
        cap = 1 if uniq_mask[c] else max(1, int(multiplicity[c]))
        return _uses(c) < cap

    def claim(c: int) -> None:
        if seq_len[c] >= params.unique_edge_length:
            uses[c] = uses.get(c, 0) + 1

    def grow(path: list[int]) -> list[int]:
        visits: dict[tuple[int, int], int] = {}
        while len(path) < params.max_path_edges:
            v = int(end_v[path[-1]])
            cands = out_of.get(v, [])
            if not cands:
                break
            # CompositeExtender semantics: the first library whose
            # chooser resolves the junction unambiguously extends
            best = None
            for chooser in choosers:
                top = chooser.filter(path, cands)
                if len(top) == 1:
                    best = top[0]
                    break
            if best is None:
                break
            # used-unique gating happens on the CHOSEN edge (TryUseEdge,
            # path_extenders.cpp:295-299): a claimed unique edge stops
            # growth rather than deflecting it to a competitor
            if not usable(best):
                break
            key = (v, best)
            visits[key] = visits.get(key, 0) + 1
            if visits[key] > params.max_junction_visits:
                break  # unresolved short loop: stop unrolling
            path.append(best)
            claim(best)
        return path

    for seed in seeds:
        if seed in seeded or int(conj[seed]) in seeded:
            continue
        if not usable(seed):
            continue
        # only UNIQUE seeds claim their edge: a collapsed-repeat seed
        # path ([R] alone, later removed as contained) must not burn a
        # multiplicity slot the flanking paths need (the reference's
        # UsedUniqueStorage tracks unique edges only)
        if uniq_mask[seed]:
            claim(seed)
        # grow right, then grow the conjugate right (= grow left), stitch
        right = grow([seed])
        left_c = grow([int(conj[seed])])
        left = [int(conj[e]) for e in reversed(left_c[1:])]
        full = left + right
        paths.append(full)
        seeded.update(full)
        seeded.update(int(conj[e]) for e in full)

    paths = _remove_overlaps(paths, conj, seq_len,
                             params.unique_edge_length)
    return PathSet(paths=paths)


def _contains(big: tuple, small: tuple) -> bool:
    if len(small) > len(big):
        return False
    for i in range(len(big) - len(small) + 1):
        if big[i:i + len(small)] == small:
            return True
    return False


def _remove_overlaps(paths: list[list[int]], conj, seq_len,
                     unique_len: int) -> list[list[int]]:
    """Containment dedup (path_deduplicator.hpp:15) + end/start overlap
    trimming (overlap_remover.hpp:77): when path A's non-unique suffix
    equals path B's prefix, the duplicated repeat copy is cut from A."""
    paths = sorted(paths, key=len, reverse=True)
    kept: list[list[int]] = []
    for p in paths:
        sp = tuple(p)
        cp = tuple(int(conj[e]) for e in reversed(p))
        if any(_contains(tuple(q), sp) or _contains(tuple(q), cp)
               for q in kept):
            continue
        kept.append(p)

    def overlap_len(a: list[int], b: tuple) -> int:
        """Longest suffix of a equal to a prefix of b, shorter than both."""
        m = min(len(a), len(b)) - 1
        for t in range(m, 0, -1):
            if tuple(a[-t:]) == b[:t]:
                return t
        return 0

    out: list[list[int]] = []
    for i, p in enumerate(kept):
        trimmed = list(p)
        for j, q in enumerate(kept):
            if i == j:
                continue
            for qv in (tuple(q), tuple(int(conj[e]) for e in reversed(q))):
                t = overlap_len(trimmed, qv)
                # cut only non-unique (repeat) suffixes, keeping at least
                # one edge (overlap_remover cuts the later path's copy)
                while t > 0 and len(trimmed) > t and \
                        all(seq_len[e] < unique_len for e in trimmed[-t:]):
                    trimmed = trimmed[:-t]
                    t = overlap_len(trimmed, qv)
        out.append(trimmed)
    return out


def paths_to_contigs(g: GraphView, ps: PathSet,
                     with_paths: bool = False) -> list:
    """Path sequences (k-overlap aware) with length-weighted coverage.

    ``with_paths`` appends the edge-id path to each row, keeping the
    sort alignment — feeds contigs.paths / GFA P-line output
    (bidirectional_path_output.hpp:25 ToPathString)."""
    g = host_view(g)
    from ..ops import dna
    flat = g.seq_flat
    starts = np.asarray(g.seq_start)
    lens = np.asarray(g.seq_len)
    covs = np.asarray(g.cov)
    k = g.k
    out = []
    for path in ps.paths:
        seq = ""
        wsum = 0.0
        wlen = 0
        for i, e in enumerate(path):
            s = dna.decode_codes(flat[starts[e]:starts[e] + lens[e]])
            seq = s if i == 0 else seq + s[k:]
            wsum += covs[e] * lens[e]
            wlen += int(lens[e])
        out.append((seq, wsum / max(wlen, 1), list(path)))
    out.sort(key=lambda sc: (-len(sc[0]), sc[0]))
    if with_paths:
        return out
    return [(s, c) for s, c, _ in out]
