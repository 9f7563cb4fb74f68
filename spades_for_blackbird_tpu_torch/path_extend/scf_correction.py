"""truSPAdes scaffold correction.

PyTorch counterpart of the JAX package's
``path_extend/scf_correction.py`` (the reference's
spades-truseq-scfcorrection binary, projects/scaffold_correction/
scaffold_correction.hpp:186-233 ``ScaffoldCorrector``): split each
scaffold at N-gaps, map every piece onto the assembly graph
(``long_read.align_long_reads``: seeding on the card through the k-mer
kernel's strand entry), fix the inter-piece gaps by bounded path search
(the ``CarefulPathFixer`` role), and emit the gapless corrected sequence
when the whole path validates (consecutive edges share vertices);
otherwise keep the original scaffold. The path search and the sequence
run on the host, on one copy of the graph (``graph/host.py``).
"""

from __future__ import annotations

import re
from collections import deque

from ..graph.graph import Graph
from ..graph.host import GraphView, edge_mask, host_view
from ..mapping import long_read
from ..ops import dna


def _adjacency(hv: GraphView):
    out_of: dict[int, list[int]] = {}
    for e in edge_mask(hv).nonzero()[0]:
        out_of.setdefault(int(hv.start_v[e]), []).append(int(e))
    return hv.start_v, hv.end_v, out_of


def _find_path(e1: int, e2: int, start_v, end_v, out_of, seq_len, k,
               max_len: int, max_nodes: int = 2000) -> list[int] | None:
    """Shortest edge path e1 -> ... -> e2 with interior length <= max_len
    (BFS by hops, bounded: the Dijkstra-limited TryFixPath analogue)."""
    if int(end_v[e1]) == int(start_v[e2]):
        return []
    q = deque([(int(end_v[e1]), 0, ())])
    seen = {int(end_v[e1]): 0}
    visited = 0
    while q:
        v, dist, path = q.popleft()
        visited += 1
        if visited > max_nodes:
            return None
        for e in out_of.get(v, []):
            nd = dist + int(seq_len[e]) - k
            if e == e2:
                return list(path)
            if nd > max_len:
                continue
            w = int(end_v[e])
            if seen.get(w, 1 << 30) <= nd:
                continue
            seen[w] = nd
            q.append((w, nd, path + (e,)))
    return None


def correct_scaffold(g: Graph, scaffold: str, max_gap_slack: int = 500,
                     device=None, hv: GraphView | None = None
                     ) -> tuple[str, bool]:
    """Returns (sequence, corrected?). Pieces are the N-free runs. The
    pieces are aligned on ``device`` (by default the graph's);
    ``hv`` is the graph's host view where the caller holds one."""
    # piece offsets come from the split spans themselves: substring
    # search would anchor a repeated piece at its first occurrence and
    # mis-size the N-gap bound
    spans = [mt.span() for mt in re.finditer("[^Nn]+", scaffold)
             if mt.end() - mt.start() > g.k + 2]
    pieces = [scaffold[a:b] for a, b in spans]
    if len(pieces) == 0:
        return scaffold, False
    gaps = [0] + [spans[i][0] - spans[i - 1][1]
                  for i in range(1, len(spans))]
    codes, lengths = dna.encode_reads(pieces)
    als = long_read.align_long_reads(g, codes, lengths, device=device)
    chains = []
    for al in als:
        if not al.chain:
            return scaffold, False
        chains.append([h.edge for h in al.chain])

    hv = host_view(g) if hv is None else hv
    start_v, end_v, out_of = _adjacency(hv)
    seq_len = hv.seq_len
    k = g.k
    full: list[int] = []
    for ci, chain in enumerate(chains):
        if full and chain[0] != full[-1]:
            gap_fill = _find_path(full[-1], chain[0], start_v, end_v,
                                  out_of, seq_len, k,
                                  max_len=max_gap_slack + gaps[ci])
            if gap_fill is None:
                return scaffold, False
            full.extend(gap_fill)
        # drop duplicate junction edge when chains overlap
        for e in chain:
            if not full or full[-1] != e:
                full.append(e)
    # validate connectivity (ScaffoldCorrector::CheckPath)
    for a, b in zip(full[:-1], full[1:]):
        if int(end_v[a]) != int(start_v[b]):
            return scaffold, False
    # construct sequence (ConstructSequence: first edge + k-trimmed rest)
    out = []
    for i, e in enumerate(full):
        s = dna.decode_codes(hv.seq_flat[hv.seq_start[e]:
                                         hv.seq_start[e] + int(seq_len[e])])
        out.append(s if i == 0 else s[k:])
    return "".join(out), True


def correct_scaffolds(g: Graph, scaffolds: list[tuple[str, str]],
                      device=None) -> tuple[list[tuple[str, str]], int]:
    """[(name, seq)] -> corrected list + number changed."""
    hv = host_view(g)
    out = []
    n = 0
    for name, seq in scaffolds:
        fixed, ok = correct_scaffold(g, seq, device=device, hv=hv)
        if ok and fixed != seq:
            n += 1
        out.append((name, fixed if ok else seq))
    return out, n
