"""Binning propagation and read binning (mts prop_binning).

PyTorch counterpart of the JAX package's ``mts/binning.py`` (the
reference's projects/mts/prop_binning.cpp + propagate.cpp: label
propagation of an external binner's annotation over the assembly graph;
read_binning.cpp: splitting read sets per bin by mapping them onto
annotated edges; stats.cpp-style summaries). The propagation and the
summaries walk one host copy of the graph (``graph/host.py``); the read
mapping runs on the device (``mapping/mapper.py``, the k-mer kernel's
strand entry on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.graph import Graph
from ..graph.host import edge_mask, host_view
from ..mapping import index as eidx
from ..mapping import mapper
from ..utils.device import resolve_device


def read_annotation(path: str) -> dict[str, str]:
    """'name<TAB>bin' per line (the mts .ann surface)."""
    out = {}
    for line in open(path):
        toks = line.split()
        if len(toks) >= 2:
            out[toks[0]] = toks[1]
    return out


def write_annotation(path: str, ann: dict[str, str]) -> None:
    with open(path, "w") as f:
        for name, b in ann.items():
            f.write(f"{name}\t{b}\n")


def propagate_bins(g, edge_bins: dict[int, str],
                   max_rounds: int = 10) -> dict[int, str]:
    """Spread bin labels to unlabeled edges: an edge adopts a label when
    all labeled neighbours (edges sharing a vertex, either side) agree
    (propagate.cpp's conservative EdgeAnnotationPropagator idea).
    Conjugate edges always share a label. ``g`` is a graph or its host
    view."""
    hv = host_view(g)
    alive = edge_mask(hv)
    start_v, end_v, conj = hv.start_v, hv.end_v, hv.conj

    at_vertex: dict[int, list[int]] = {}
    for e in np.nonzero(alive)[0]:
        at_vertex.setdefault(int(start_v[e]), []).append(int(e))
        at_vertex.setdefault(int(end_v[e]), []).append(int(e))

    labels = dict(edge_bins)
    for e in list(labels):
        labels[int(conj[e])] = labels[e]
    for _ in range(max_rounds):
        changed = False
        for e in np.nonzero(alive)[0]:
            e = int(e)
            if e in labels:
                continue
            neigh = set()
            for v in (int(start_v[e]), int(end_v[e])):
                for o in at_vertex.get(v, []):
                    if o != e and o in labels:
                        neigh.add(labels[o])
            if len(neigh) == 1:
                b = neigh.pop()
                labels[e] = b
                labels[int(conj[e])] = b
                changed = True
        if not changed:
            break
    return labels


def bin_reads(g: Graph, edge_bins: dict[int, str], codes, lengths,
              device=None) -> dict[str, np.ndarray]:
    """Read indices per bin, by mapping each read onto the graph and
    looking up its winning edge's bin (read_binning.cpp). The index and
    the mapping run on ``device`` (``resolve_device``: by default the
    graph's card, else the first card; the CPU only on request)."""
    device = resolve_device(device, g.seq_flat)
    g = g.to(device)
    idx = eidx.build_edge_index(g, g.k + 1, device=device)
    m = mapper.map_reads(
        idx, g.seq_len,
        torch.as_tensor(codes).to(device=device, dtype=torch.uint8),
        torch.as_tensor(lengths).to(device=device, dtype=torch.int32),
        g.k + 1)
    m = mapper.normalize_mapping(m, g.conj)
    oe = (m.oriented_edge // 2).cpu().numpy()
    ok = m.mapped.cpu().numpy()
    out: dict[str, list[int]] = {}
    for r in np.nonzero(ok)[0]:
        b = edge_bins.get(int(oe[r]))
        if b is not None:
            out.setdefault(b, []).append(int(r))
    return {b: np.asarray(v) for b, v in out.items()}


def binning_stats(g, edge_bins: dict[int, str]) -> dict[str, dict]:
    """Per-bin edge count / total length / mean coverage (stats.cpp).
    ``g`` is a graph or its host view."""
    hv = host_view(g)
    alive = edge_mask(hv)
    lens, cov, conj = hv.seq_len, hv.cov, hv.conj
    stats: dict[str, dict] = {}
    seen = set()
    for e, b in edge_bins.items():
        if not alive[e] or e in seen:
            continue
        seen.add(e)
        seen.add(int(conj[e]))
        s = stats.setdefault(b, {"edges": 0, "length": 0, "cov_sum": 0.0})
        s["edges"] += 1
        s["length"] += int(lens[e])
        s["cov_sum"] += float(cov[e]) * int(lens[e])
    for b, s in stats.items():
        s["mean_cov"] = s.pop("cov_sum") / max(s["length"], 1)
    return stats
