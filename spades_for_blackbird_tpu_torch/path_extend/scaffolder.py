"""Scaffolding: join resolved paths across gaps using paired distances.

The port's copy of the JAX package's ``path_extend/scaffolder.py``:
host NumPy, as there; a graph on the card is copied to the host once,
at the top of each pass (``graph/host.host_view``).

Counterpart of the reference's scaffolding machinery
(modules/path_extend/scaffolder2015/scaffold_graph.{hpp,cpp} +
ScaffoldingPathExtender at path_extender.hpp:580, gap estimation from
clustered paired info): path ends supported by distance-consistent mate
pairs but with no graph connection are joined with an ``N`` gap sized by
the distance estimate (scaffold breaking at gaps is then the reference's
breaking_scaffolds_stage in reverse).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graph.host import GraphView, edge_mask, host_view
from ..ops import dna
from .resolver import PathSet


@dataclass
class ScaffoldParams:
    min_weight: float = 5.0       # pair support to accept a join
    max_gap: int = 10000
    min_gap_run: int = 1          # emitted N run is at least this long
    # gap analysis (gap_analyzer.cpp; thresholds scale with the library
    # insert-size variation, extenders_logic.cpp:86-108 MakeGapAnalyzer)
    is_variation: float = 75.0
    read_length: int = 100
    # scaffolding anchors must be unique edges (ScaffoldingUniqueEdge
    # Storage, scaff_supplementary.cpp:55-62) of at least this length
    unique_length: int = 500
    unique_variation: float = 0.5
    # drop joins whose runner-up weight is within this factor of the
    # best (ExtensionChooser2015 relative_weight_threshold_)
    relative_weight_threshold: float = 2.0


def scaffold_paths(g: GraphView, ps: PathSet, paired,
                   params: ScaffoldParams | None = None,
                   forced_joins: list | None = None,
                   sg_out: dict | None = None
                   ) -> list[list[tuple[int, int]]]:
    """Join paths into scaffolds.

    ``paired``: clustered PairedIndex over *forward edge ids* (even
    oriented ids, mapper.normalize_mapping convention).

    ``forced_joins``: pre-committed joins [((i, flip), (j, flip), gap)]
    from the loop traverser (loop_traverser.cpp joins with a fixed
    k+100 N gap); applied before paired-evidence joins.

    Returns scaffolds as lists of (edge_id, gap_before) — gap_before is
    the N-gap inserted before the edge (0 for the first edge and for
    graph-adjacent edges).
    """
    g = host_view(g)
    from . import scaffold_graph as sgmod
    if params is None:
        params = ScaffoldParams()
    conj = np.asarray(g.conj)
    k = g.k

    # explicit scaffold graph (scaffolder2015): the paired connection
    # condition yields the candidate-join records; joins below consume
    # the graph's edge table. closure=False: each pair observation is
    # already canonical here, and the endpoint maps consider both path
    # orientations.
    # joins anchor on UNIQUE edges only (ExtensionChooser2015 walks
    # unique->unique connections; scaff_supplementary.cpp uniqueness =
    # long + coverage within (1 +- var) of the long-edge median)
    from . import unique_edges as ue
    unique = ue.unique_edge_mask(g, params.unique_length,
                                 params.unique_variation)
    if not unique.any():  # tiny/synthetic graphs: anchor on any edge
        unique = np.asarray(edge_mask(g))
    records = sgmod.paired_connection_records(
        g, paired, 0, min_weight=params.min_weight, left_delta=k,
        right_delta=params.max_gap, closure=False,
        unique_mask=unique | unique[conj])
    sg = sgmod.build_scaffold_graph(g, [records])
    if sg_out is not None:
        # the full (conjugate-closed, adjacency-annotated) structure,
        # as PrintScaffoldGraph dumps it (launcher.cpp:85)
        sg_out["graph"] = sgmod.scaffold_graph_from_paired(
            g, [paired], min_weight=params.min_weight,
            max_gap=params.max_gap)

    paths = [list(p) for p in ps.paths]

    def oriented(i: int, flip: bool) -> list[int]:
        p = paths[i]
        return [int(conj[e]) for e in reversed(p)] if flip else p

    # endpoint maps over both orientations of every path, anchored on
    # the LAST/FIRST UNIQUE edge (FindLastUniqueInPath,
    # extension_chooser2015.cpp:10-17); the skipped non-unique tail/head
    # length corrects the estimated gap at join time
    seq_len_h = np.asarray(g.seq_len)
    last_of: dict[int, tuple[int, bool, int]] = {}
    first_of: dict[int, tuple[int, bool, int]] = {}
    for i in range(len(paths)):
        for flip in (False, True):
            op = oriented(i, flip)
            trail = 0
            for e in reversed(op):
                if unique[e]:
                    last_of.setdefault(e, (i, flip, trail))
                    break
                trail += int(seq_len_h[e]) - k
            else:
                last_of.setdefault(op[-1], (i, flip, 0))
            lead = 0
            for e in op:
                if unique[e]:
                    first_of.setdefault(e, (i, flip, lead))
                    break
                lead += int(seq_len_h[e]) - k
            else:
                first_of.setdefault(op[0], (i, flip, 0))

    joins = []
    for j in range(sg.edge_count):
        a, b = int(sg.src[j]), int(sg.dst[j])
        if a in last_of and b in first_of:
            (i, fi, trail), (jdx, fj, lead) = last_of[a], first_of[b]
            if i != jdx:
                joins.append((float(sg.weight[j]), (i, fi), (jdx, fj),
                              int(sg.gap[j]) - trail - lead))

    # relative-weight ambiguity rejection (extension_chooser2015.cpp:
    # 44-54): a tail (or head) whose runner-up candidate weight is
    # within relative_weight_threshold of the best is ambiguous — no
    # join is made from it at all
    by_src: dict[tuple[int, bool], list[float]] = {}
    by_dst: dict[tuple[int, bool], list[float]] = {}
    for w, src, dst, gap in joins:
        by_src.setdefault(src, []).append(w)
        by_dst.setdefault(dst, []).append(w)

    def ambiguous(key, table, w):
        ws = table[key]
        if len(ws) < 2:
            return False
        top = sorted(ws, reverse=True)
        return w < top[0] or \
            top[1] * params.relative_weight_threshold > top[0]

    joins = [(w, s, d, gp) for (w, s, d, gp) in joins
             if not ambiguous(s, by_src, w)
             and not ambiguous(d, by_dst, w)]

    joins.sort(key=lambda t: -t[0])
    used_tail = set()   # path ids whose (oriented) tail is taken
    used_head = set()
    next_of: dict[tuple[int, bool], tuple[tuple[int, bool], int]] = {}
    for src, dst, gap in (forced_joins or []):
        if src[0] in used_tail or dst[0] in used_head or src[0] == dst[0]:
            continue
        used_tail.add(src[0])
        used_head.add(dst[0])
        next_of[src] = (dst, gap)

    # gap analysis per candidate join (CompositeGapAnalyzer::FixGap):
    # look for an actual suffix/prefix overlap before committing Ns, and
    # reject joins whose strongly-negative estimate finds no overlap
    from . import gap_analyzer as ga
    flat_h = g.seq_flat
    starts_h = np.asarray(g.seq_start)
    lens_h = np.asarray(g.seq_len)
    gparams = ga.GapAnalyzerParams(
        basic_overlap=2 * params.read_length,
        may_overlap_threshold=int(round(params.is_variation)),
        must_overlap_threshold=-int(round(3.0 * params.is_variation)))

    def edge_seq(e: int) -> np.ndarray:
        return flat_h[starts_h[e]:starts_h[e] + lens_h[e]]

    for w, src, dst, gap in joins:
        if src[0] in used_tail or dst[0] in used_head:
            continue
        # a path may appear in only one orientation overall
        if (src[0], not src[1]) in next_of or \
                any(d[0] == src[0] and d[1] != src[1]
                    for d, _ in next_of.values()):
            continue
        if gap != -k:  # graph-adjacent joins need no analysis
            fixed = ga.composite_fix_gap(
                edge_seq(oriented(*src)[-1]), edge_seq(oriented(*dst)[0]),
                int(gap), k, gparams)
            if fixed is ga.REJECT:
                continue
            gap = int(fixed)
        used_tail.add(src[0])
        used_head.add(dst[0])
        next_of[src] = (dst, gap)

    # chain heads: non-dst paths, started in the orientation that has an
    # outgoing join (or forward if standalone)
    heads = []
    for i in range(len(paths)):
        if i in used_head:
            continue
        flip = (i, True) in next_of
        heads.append((i, flip))

    scaffolds = []
    consumed = set()
    for h in heads:
        chain: list[tuple[int, int]] = []
        node = h
        gap_in = 0
        while node[0] not in consumed:
            consumed.add(node[0])
            for idx, e in enumerate(oriented(*node)):
                chain.append((e, gap_in if idx == 0 else 0))
                gap_in = 0
            if node not in next_of:
                break
            node, gap_in = next_of[node]
        scaffolds.append(chain)
    for i in range(len(paths)):
        if i not in consumed:
            scaffolds.append([(e, 0) for e in paths[i]])
    return scaffolds


def scaffolds_to_contigs(g: GraphView, scaffolds,
                         min_gap_run: int = 1,
                         with_paths: bool = False) -> list:
    """Render scaffolds as sequences with N gaps (io_support.cpp's
    scaffold writing; gaps clamp to at least min_gap_run Ns).

    ``with_paths`` appends the (edge, gap) chain to each row, keeping
    the sort alignment — feeds scaffolds.paths / GFA P-line output."""
    g = host_view(g)
    from ..ops import dna
    flat = g.seq_flat
    starts = np.asarray(g.seq_start)
    lens = np.asarray(g.seq_len)
    covs = np.asarray(g.cov)
    k = g.k
    out = []
    for chain in scaffolds:
        seq = ""
        wsum, wlen = 0.0, 0
        for idx, (e, gap) in enumerate(chain):
            s = dna.decode_codes(flat[starts[e]:starts[e] + lens[e]])
            if idx == 0:
                seq = s
            elif gap > 0:
                seq += "N" * max(gap, min_gap_run) + s
            elif gap <= 0:
                # distance says slight overlap/adjacency: butt-join minus
                # the k overlap when graph-adjacent (gap == -k)
                ov = min(-gap, len(s)) if gap < 0 else 0
                seq += s[ov:] if ov else s
            wsum += covs[e] * lens[e]
            wlen += int(lens[e])
        out.append((seq, wsum / max(wlen, 1),
                    [(int(e), int(gap)) for e, gap in chain]))
    out.sort(key=lambda sc: (-len(sc[0]), sc[0]))
    if with_paths:
        return out
    return [(s, c) for s, c, _ in out]
