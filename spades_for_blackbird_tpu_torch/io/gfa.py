"""GFA1 assembly-graph writer.

PyTorch counterpart of the JAX package's ``io/gfa.py`` (the
reference's GFA writer, common/io/graph/gfa_writer.hpp:27): one S(egment)
per conjugate edge pair (the lower id of the pair is the stored
orientation = '+'), L(ink) records for every pair of edges meeting at a
vertex, with k-base overlaps. Every writer copies the graph's fields to
the host once (``host_fields``) and works on NumPy arrays from there.
"""

from __future__ import annotations

import numpy as np

from ..graph.graph import Graph, edge_mask
from ..ops import dna


def host_fields(g: Graph, *names: str) -> dict:
    """{name: NumPy array} of the named graph fields, plus ``alive`` (the
    mask of alive real edges): one copy to the host a field."""
    out = {name: getattr(g, name).cpu().numpy() for name in names}
    out["alive"] = edge_mask(g).cpu().numpy()
    return out


def _segments(alive, conj):
    """alive canonical edges: list of (edge_id, conj_id)."""
    segs = []
    for e in np.nonzero(alive)[0]:
        if conj[e] < e and alive[conj[e]]:
            continue
        segs.append((int(e), int(conj[e])))
    return segs


def segment_naming(g: Graph):
    """Edge id -> (segment name, orientation) for GFA/paths output.

    The canonical edge of each conjugate pair is '+'; names are dense
    ints 1..n (io/utils/edge_namer.hpp BasicNamingF equivalent).
    """
    h = host_fields(g, "conj")
    segs, seg_of = _segment_naming(h["alive"], h["conj"])
    return segs, seg_of, h["alive"], h["conj"]


def _segment_naming(alive, conj):
    segs = _segments(alive, conj)
    seg_of = {}      # edge id -> (segment name, orientation char)
    for i, (e, ce) in enumerate(segs, start=1):
        seg_of[e] = (i, "+")
        seg_of[ce] = (i, "-")
    return segs, seg_of


def _split_path_segments(start_v, end_v, chain, seg_of):
    """Split an (edge, gap) chain at discontinuities: graph-nonadjacent
    consecutive edges or positive gaps (GFAPathWriter::WritePaths,
    bidirectional_path_output.hpp:90-103 split rule).

    Returns a list of segments, each a list of 'name[+-]' strings.
    """
    segments, cur = [], []
    prev_e = None
    for e, gap in chain:
        if e not in seg_of:
            continue
        s, o = seg_of[e]
        if prev_e is not None and (gap > 0
                                   or end_v[prev_e] != start_v[e]):
            segments.append(cur)
            cur = []
        cur.append(f"{s}{o}")
        prev_e = e
    if cur:
        segments.append(cur)
    return segments


def conjugate_chain(g: Graph, chain):
    """The reverse-complement path: reversed conjugate edges, gaps
    shifted to stay *before* the edge they preceded (GetConjPath)."""
    return _conjugate_chain(g.conj.cpu().numpy(), chain)


def _conjugate_chain(conj, chain):
    rev = []
    gaps = [gap for _, gap in chain][1:] + [0]
    for (e, _), gap_after in zip(reversed(chain), reversed(gaps)):
        rev.append((int(conj[e]), int(gap_after)))
    # first edge of a path carries no gap
    if rev:
        rev[0] = (rev[0][0], 0)
    return rev


def write_paths_file(path: str, g: Graph, named_paths) -> None:
    """contigs.paths / scaffolds.paths: per path, the name line then the
    edge-orientation string ('52+,43-' with ';\\n' at breaks), then the
    conjugate path under name' (FastgPathWriter::WritePaths,
    bidirectional_path_output.hpp:55-63 + ToPathString :25-37).

    ``named_paths``: list of (name, chain) with chain = [(edge, gap)].
    """
    h = host_fields(g, "conj", "start_v", "end_v")
    _, seg_of = _segment_naming(h["alive"], h["conj"])
    with open(path, "w") as f:
        for name, chain in named_paths:
            for nm, ch in ((name, chain),
                           (name + "'", _conjugate_chain(h["conj"], chain))):
                segs = _split_path_segments(h["start_v"], h["end_v"], ch,
                                            seg_of)
                if not segs:
                    continue
                f.write(nm + "\n")
                f.write(";\n".join(",".join(s) for s in segs) + "\n")


def write_gfa(path: str, g: Graph, paths=None) -> None:
    """GFA1 graph; ``paths`` (list of (name, [(edge, gap)])) adds one
    P record per contiguous path segment (GFAPathWriter::WritePaths,
    bidirectional_path_output.hpp:70-103; the reference populates these
    from the scaffold storage, contig_output_stage.cpp:105-112)."""
    h = host_fields(g, "conj", "seq_start", "seq_len", "cov", "seq_flat",
                    "start_v", "end_v")
    alive, starts, lens, covs = (h["alive"], h["seq_start"], h["seq_len"],
                                 h["cov"])
    flat, start_v, end_v = h["seq_flat"], h["start_v"], h["end_v"]
    segs, seg_of = _segment_naming(alive, h["conj"])
    k = g.k

    with open(path, "w") as f:
        f.write("H\tVN:Z:1.0\n")
        for i, (e, _) in enumerate(segs, start=1):
            seq = dna.decode_codes(flat[starts[e]:starts[e] + lens[e]])
            # KC = total k-mer count (reference writes KC:i: on segments)
            kc = int(round(covs[e] * max(lens[e] - k, 1)))
            f.write(f"S\t{i}\t{seq}\tDP:f:{covs[e]:.6f}\tKC:i:{kc}\n")
        # links: for each vertex, incoming x outgoing
        by_start = {}
        for e in np.nonzero(alive)[0]:
            by_start.setdefault(int(start_v[e]), []).append(int(e))
        emitted = set()
        for e in np.nonzero(alive)[0]:
            v = int(end_v[e])
            for e2 in by_start.get(v, []):
                s1, o1 = seg_of[int(e)]
                s2, o2 = seg_of[e2]
                key = (s1, o1, s2, o2)
                # the conjugate link (rc pair) is the same GFA link
                flip = {"+": "-", "-": "+"}
                rkey = (s2, flip[o2], s1, flip[o1])
                if key in emitted or rkey in emitted:
                    continue
                emitted.add(key)
                f.write(f"L\t{s1}\t{o1}\t{s2}\t{o2}\t{k}M\n")
        if paths:
            for name, chain in paths:
                psegs = _split_path_segments(start_v, end_v, chain, seg_of)
                for sid, seg in enumerate(psegs, start=1):
                    f.write(f"P\t{name}_{sid}\t{','.join(seg)}\t*\n")


def read_gfa(path: str, with_paths: bool = False):
    """Minimal GFA reader (segments + links), for --assembly-graph input
    (the fork's load_graph stage, projects/spades/load_graph.cpp:16).

    Returns (segments: dict name -> (seq, cov), links: list of
    (name1, orient1, name2, orient2, overlap)); with ``with_paths``,
    also a list of (path_name, ['seg+', 'seg-', ...]) from P records.
    """
    segments = {}
    links = []
    paths = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if not parts:
                continue
            if parts[0] == "S":
                name, seq = parts[1], parts[2]
                cov = 0.0
                for tag in parts[3:]:
                    if tag.startswith("DP:f:"):
                        cov = float(tag[5:])
                    elif tag.startswith("KC:i:") and cov == 0.0:
                        cov = float(tag[5:]) / max(len(seq), 1)
                segments[name] = (seq, cov)
            elif parts[0] == "L":
                ov = int(parts[5].rstrip("M")) if len(parts) > 5 else 0
                links.append((parts[1], parts[2], parts[3], parts[4], ov))
            elif parts[0] == "P" and len(parts) > 2:
                paths.append((parts[1], parts[2].split(",")))
    if with_paths:
        return segments, links, paths
    return segments, links
