"""Build a Graph from a GFA file.

PyTorch counterpart of the JAX package's ``graph/from_gfa.py``,
the fork's graph-input path (projects/spades/load_graph.cpp:16-36,
LoadGraph behind --assembly-graph, reading with io/graph/gfa_reader.cpp):
segments become conjugate edge pairs with their DP/KC coverage, and link
records glue edge endpoints into shared vertices (union-find over
endpoints, as FastGraphFromSequencesConstructor groups junctions). The
arrays are built with NumPy on the host, then put on the device once.
"""

from __future__ import annotations

import numpy as np

from .. import interop
from ..io import gfa as gfa_io
from ..ops import dna
from ..utils.device import resolve_device


def graph_from_gfa(path: str, return_names: bool = False, device=None):
    """The graph of a GFA file, on ``device`` (``resolve_device``: the
    card unless ``"cpu"`` is asked for). Edge 2i is segment i forward,
    2i+1 its reverse complement; k is the links' overlap (the largest
    where they differ, 21 without links). With ``return_names`` also
    {forward edge id -> segment name}."""
    device = resolve_device(device)
    segments, links = gfa_io.read_gfa(path)
    names = list(segments.keys())
    name_idx = {n: i for i, n in enumerate(names)}
    S = len(names)
    E = 2 * S
    if S == 0:
        raise ValueError(f"{path}: no segments")

    ks = {ov for *_, ov in links}
    k = ks.pop() if len(ks) == 1 else (max(ks) if ks else 21)

    seqs = [segments[n][0] for n in names]
    covs = np.repeat(np.array([segments[n][1] for n in names], np.float32),
                     2)

    def edge_id(name: str, orient: str) -> int:
        return 2 * name_idx[name] + (0 if orient == "+" else 1)

    # endpoint points: 2e = start of edge e, 2e+1 = end of edge e
    parent = list(range(2 * E))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    flip = {"+": "-", "-": "+"}
    for n1, o1, n2, o2, _ in links:
        if n1 not in name_idx or n2 not in name_idx:
            continue
        a, b = edge_id(n1, o1), edge_id(n2, o2)
        union(2 * a + 1, 2 * b)            # end(a) == start(b)
        ca, cb = edge_id(n1, flip[o1]), edge_id(n2, flip[o2])
        union(2 * cb + 1, 2 * ca)          # the conjugate link

    # vertices come in conjugate pairs: an endpoint class gets v, the
    # class of the conjugate endpoints (the conjugate edge's other end)
    # v ^ 1
    rep_to_vertex: dict[int, int] = {}
    next_v = 0
    start_v = np.zeros(E, np.int64)
    end_v = np.zeros(E, np.int64)

    def vertex_of(point: int) -> int:
        nonlocal next_v
        r = find(point)
        if r in rep_to_vertex:
            return rep_to_vertex[r]
        e, is_end = divmod(point, 2)
        cr = find(2 * (e ^ 1) + (1 - is_end))
        rep_to_vertex[r] = next_v
        rep_to_vertex[cr] = next_v + 1 if cr != r else next_v
        next_v += 2
        return rep_to_vertex[r]

    for e in range(E):
        start_v[e] = vertex_of(2 * e)
        end_v[e] = vertex_of(2 * e + 1)

    lens = np.repeat(np.array([len(s) for s in seqs], np.int64), 2)
    seq_start = np.cumsum(lens) - lens
    seq_flat = np.zeros(int(lens.sum()), np.uint8)
    for i, s in enumerate(seqs):
        fwd = dna.encode_str(s)
        rc = np.where(fwd >= dna.INVALID_CODE, fwd, 3 - fwd)[::-1]
        seq_flat[seq_start[2 * i]:seq_start[2 * i] + len(s)] = fwd
        seq_flat[seq_start[2 * i + 1]:seq_start[2 * i + 1] + len(s)] = rc

    g = interop.graph_from_numpy({
        "seq_flat": seq_flat, "seq_start": seq_start, "seq_len": lens,
        "cov": covs, "start_v": start_v, "end_v": end_v,
        "conj": np.arange(E) ^ 1, "alive": np.ones(E, bool),
        "num_edges": np.int64(E)}, int(k), device)
    if return_names:
        return g, {2 * i: n for i, n in enumerate(names)}
    return g
