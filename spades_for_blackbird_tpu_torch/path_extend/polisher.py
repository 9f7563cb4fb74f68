"""Path polisher: replace scaffold N-gaps with real graph paths.

The port's copy of the JAX package's ``path_extend/polisher.py``:
host NumPy, as there; a graph on the card is copied to the host once,
at the top of each pass (``graph/host.host_view``).

Counterpart of the reference's ``PathPolisher`` + ``DijkstraGapCloser``
(modules/path_extend/scaffolder2015/path_polisher.cpp:1-362): every gap
in a scaffold chain is a pair of edges the paired evidence says are
near each other but the extender could not connect. A bounded search
enumerates graph paths between the gap's endpoint vertices; when the
connection is unambiguous (exactly one path within the length bound, or
all paths agree — we implement the unique-path case, the dominant one
in practice), the N-run is replaced by the actual path edges.
"""

from __future__ import annotations

import numpy as np

from ..graph.host import GraphView, edge_mask, host_view

MAX_POLISH_ATTEMPTS = 5  # path_polisher.hpp:121


def _paths_between(out_of, end_v, seq_len, k, src, dst, max_len,
                   max_paths: int = 8):
    """All edge paths src->dst with interior bp length <= max_len
    (DijkstraGapCloser's path enumeration, capped)."""
    results = []
    stack = [(src, [], 0)]
    while stack and len(results) <= max_paths:
        v, path, ln = stack.pop()
        if v == dst and path:
            results.append(path)
            continue
        if ln > max_len:
            continue
        for e in out_of.get(v, []):
            if len(path) > 24:
                continue
            stack.append((int(end_v[e]), path + [e],
                          ln + int(seq_len[e]) - k))
    return results


def polish_scaffolds(g: GraphView, scaffolds, max_path_len: int = 1000
                     ) -> tuple[list, int]:
    """Close scaffold gaps with unique graph paths.

    ``scaffolds``: list of chains [(edge, gap_before), ...] as produced
    by scaffolder.scaffold_paths. Returns (polished scaffolds, number of
    gaps closed)."""
    g = host_view(g)
    alive = np.asarray(edge_mask(g))
    start_v = np.asarray(g.start_v)
    end_v = np.asarray(g.end_v)
    seq_len = np.asarray(g.seq_len)
    k = g.k
    out_of: dict[int, list[int]] = {}
    for e in np.nonzero(alive)[0]:
        out_of.setdefault(int(start_v[e]), []).append(int(e))

    closed = 0
    polished = []
    for chain in scaffolds:
        for _ in range(MAX_POLISH_ATTEMPTS):
            new_chain = [chain[0]]
            changed = False
            for idx in range(1, len(chain)):
                e, gap = chain[idx]
                prev_e = new_chain[-1][0]
                if gap > 0:
                    cands = _paths_between(
                        out_of, end_v, seq_len, k,
                        int(end_v[prev_e]), int(start_v[e]),
                        min(max_path_len, gap + 2 * k + 200))
                    if len(cands) == 1:
                        for m in cands[0]:
                            new_chain.append((int(m), 0))
                        new_chain.append((e, 0))
                        closed += 1
                        changed = True
                        continue
                new_chain.append((e, gap))
            chain = new_chain
            if not changed:
                break
        polished.append(chain)
    return polished, closed
