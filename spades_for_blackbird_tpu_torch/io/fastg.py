"""FASTG assembly-graph writer.

PyTorch counterpart of the JAX package's ``io/fastg.py`` (the
reference's FASTG writer, common/io/graph/fastg_writer.cpp): SPAdes-style
headers ``>EDGE_i_length_L_cov_C[:successor[,successor...]];``
with ``'`` marking reverse-complement orientation.
"""

from __future__ import annotations

import numpy as np

from ..graph.graph import Graph
from ..ops import dna
from .gfa import host_fields


def _edge_name(i: int, length: int, cov: float, rc: bool) -> str:
    return f"EDGE_{i}_length_{length}_cov_{cov:.6f}" + ("'" if rc else "")


def write_fastg(path: str, g: Graph, line_width: int = 60) -> None:
    h = host_fields(g, "conj", "seq_start", "seq_len", "cov", "seq_flat",
                    "start_v", "end_v")
    alive, conj, starts, lens = (h["alive"], h["conj"], h["seq_start"],
                                 h["seq_len"])
    covs, flat, start_v, end_v = (h["cov"], h["seq_flat"], h["start_v"],
                                  h["end_v"])

    # numbering: one id per conjugate pair, in canonical-edge order
    ids = {}
    next_id = 1
    for e in np.nonzero(alive)[0]:
        ce = int(conj[e])
        if ce in ids:
            ids[int(e)] = (ids[ce][0], True)
        else:
            ids[int(e)] = (next_id, False)
            next_id += 1

    by_start = {}
    for e in np.nonzero(alive)[0]:
        by_start.setdefault(int(start_v[e]), []).append(int(e))

    def name(e: int) -> str:
        i, rc = ids[e]
        return _edge_name(i, int(lens[e]), float(covs[e]), rc)

    with open(path, "w") as f:
        for e in np.nonzero(alive)[0]:
            succs = by_start.get(int(end_v[e]), [])
            header = ">" + name(int(e))
            if succs:
                header += ":" + ",".join(name(s) for s in sorted(succs))
            f.write(header + ";\n")
            seq = dna.decode_codes(flat[starts[e]:starts[e] + lens[e]])
            for j in range(0, len(seq), line_width):
                f.write(seq[j:j + line_width] + "\n")
