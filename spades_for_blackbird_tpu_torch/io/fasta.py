"""Contig/FASTA output with SPAdes-compatible naming.

PyTorch counterpart of the JAX package's ``io/fasta.py``
(the reference's ``NODE_i_length_l_cov_c`` headers).
"""

from __future__ import annotations

import numpy as np

from ..graph.graph import Graph, edge_mask
from ..ops import dna


def graph_contigs(g: Graph, min_length: int = 0, with_edges: bool = False
                  ) -> list:
    """Alive edges as (sequence, coverage), one per conjugate pair.

    Of each conjugate pair, the edge whose id is <= its conjugate's is
    emitted (self-conjugate edges emit once). Sorted by descending length
    then sequence for determinism. ``with_edges`` appends the edge id to
    each row.
    """
    alive = edge_mask(g).cpu().numpy()
    conj = g.conj.cpu().numpy()
    starts = g.seq_start.cpu().numpy()
    lens = g.seq_len.cpu().numpy()
    covs = g.cov.cpu().numpy()
    used = int((starts[alive] + lens[alive]).max()) if alive.any() else 0
    flat = g.seq_flat[:used].cpu().numpy()
    out = []
    for e in np.nonzero(alive)[0]:
        if conj[e] < e and alive[conj[e]]:
            continue
        if lens[e] < min_length:
            continue
        seq = dna.decode_codes(flat[starts[e]:starts[e] + lens[e]])
        out.append((seq, float(covs[e]), int(e)))
    out.sort(key=lambda sc: (-len(sc[0]), sc[0]))
    if with_edges:
        return out
    return [(s, c) for s, c, _ in out]


def write_contigs_fasta(path: str, contigs: list[tuple[str, float]],
                        line_width: int = 60) -> None:
    """Write contigs with SPAdes naming: >NODE_i_length_L_cov_C."""
    with open(path, "w") as f:
        for i, (seq, cov) in enumerate(contigs, start=1):
            f.write(f">NODE_{i}_length_{len(seq)}_cov_{cov:.6f}\n")
            for j in range(0, len(seq), line_width):
                f.write(seq[j:j + line_width] + "\n")
