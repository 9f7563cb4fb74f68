"""Carry pipeline state between NumPy arrays and the port's structures.

The JAX package keeps k-mer words as uint32 and indices as int32; the
port keeps words as int64 values in [0, 2**32) and indices as int64.
These functions convert both ways, so that state produced elsewhere
(for example the JAX package's counted table or built graph, read out
with ``numpy.asarray``) can enter any stage of the port, and the port's
state can be compared bit for bit with it. The repeat resolution's
state crosses too: the edge k-mer index (JAX words <-> fused keys), read
and chain mappings, paired indices, insert-size statistics and path
sets; so do the profile HMMs of the HMM modes (their models play the
part of a model's weights here) and the long-read alignments.
"""

from __future__ import annotations

import numpy as np
import torch

from .graph.graph import Graph
from .hammer.bayes import KmerQualStats, SubClusters
from .hammer.cluster import HammerClusters
from .kmers.counter import KmerTable
from .kmers.extension import VertexTable
from .mapping.index import EdgeKmerIndex
from .mapping.mapper import ChainMapping, ReadMapping
from .ops import dna, segments
from .ops.hmm import HMMProfile
from .paired.insert_size import InsertSizeStats
from .paired.pair_info import PairedIndex, host_index
from .path_extend.resolver import PathSet

GRAPH_FIELDS = ("seq_flat", "seq_start", "seq_len", "cov", "start_v",
                "end_v", "conj", "alive", "num_edges", "flank")


def fields_of(obj, names) -> dict:
    """{name: numpy array} of the named attributes of ``obj`` (None
    stays None)."""
    out = {}
    for name in names:
        value = getattr(obj, name)
        out[name] = None if value is None else np.asarray(value)
    return out


def _words(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)


def _scalar(a, device) -> torch.Tensor:
    return torch.tensor(int(a), dtype=torch.int64, device=device)


def _as(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).astype(dtype))).to(device)


def kmer_table_from_numpy(kmers, counts, num, device="cpu") -> KmerTable:
    """uint32 (N, W) words, (N,) counts and a row count -> KmerTable."""
    return KmerTable(_words(kmers, device), _as(counts, np.int32, device),
                     _scalar(num, device))


def kmer_table_to_numpy(t: KmerTable) -> dict:
    """KmerTable -> {kmers: uint32 (N, W), counts: int32, num: int}."""
    return {"kmers": t.kmers.cpu().numpy().astype(np.uint32),
            "counts": t.counts.cpu().numpy().astype(np.int32),
            "num": int(t.num)}


def vertex_table_from_numpy(kmers, out_mask, in_mask, num,
                            device="cpu") -> VertexTable:
    return VertexTable(_words(kmers, device),
                       _as(out_mask, np.uint8, device),
                       _as(in_mask, np.uint8, device),
                       _scalar(num, device))


def vertex_table_to_numpy(vt: VertexTable) -> dict:
    return {"kmers": vt.kmers.cpu().numpy().astype(np.uint32),
            "out_mask": vt.out_mask.cpu().numpy(),
            "in_mask": vt.in_mask.cpu().numpy(),
            "num": int(vt.num)}


def graph_from_numpy(arrays: dict, k: int, device="cpu") -> Graph:
    """{field: numpy array} (``GRAPH_FIELDS``; flank may be None) -> Graph."""
    flank = arrays.get("flank")
    return Graph(
        seq_flat=_as(arrays["seq_flat"], np.uint8, device),
        seq_start=_as(arrays["seq_start"], np.int64, device),
        seq_len=_as(arrays["seq_len"], np.int64, device),
        cov=_as(arrays["cov"], np.float32, device),
        start_v=_as(arrays["start_v"], np.int64, device),
        end_v=_as(arrays["end_v"], np.int64, device),
        conj=_as(arrays["conj"], np.int64, device),
        alive=_as(arrays["alive"], np.bool_, device),
        num_edges=_scalar(arrays["num_edges"], device),
        k=k,
        flank=None if flank is None else _as(flank, np.float32, device))


def graph_to_saved_arrays(g: Graph) -> dict:
    """Graph -> {field: numpy array} as checkpoint files hold it: the JAX
    package's dtypes (int32 indices, 0-dim int32 ``num_edges``), ``flank``
    only where the graph has one. ``graph_from_numpy`` reads it back, and
    so does the JAX package."""
    out = {}
    for name, value in graph_to_numpy(g).items():
        if value is None:
            continue
        if name == "num_edges" or value.dtype == np.int64:
            value = np.asarray(value, dtype=np.int32)
        out[name] = value
    return out


def graph_to_numpy(g: Graph) -> dict:
    """Graph -> {field: numpy array}, indices as int64, num_edges as int."""
    out = {name: (None if getattr(g, name) is None
                  else getattr(g, name).cpu().numpy())
           for name in GRAPH_FIELDS if name != "num_edges"}
    out["num_edges"] = int(g.num_edges)
    return out


def hammer_clusters_from_numpy(rep, is_center, solid, center_of,
                               device="cpu") -> HammerClusters:
    """The JAX package's ``HammerClusters`` fields (int32 rows, bool
    flags) -> the port's (int64 rows)."""
    return HammerClusters(rep=_as(rep, np.int64, device),
                          is_center=_as(is_center, np.bool_, device),
                          solid=_as(solid, np.bool_, device),
                          center_of=_as(center_of, np.int64, device))


def hammer_clusters_to_numpy(c: HammerClusters) -> dict:
    """HammerClusters -> {field: numpy array}, rows as the JAX package's
    int32."""
    return {"rep": c.rep.cpu().numpy().astype(np.int32),
            "is_center": c.is_center.cpu().numpy(),
            "solid": c.solid.cpu().numpy(),
            "center_of": c.center_of.cpu().numpy().astype(np.int32)}


def qual_stats_from_numpy(total_lq, qual_sum, device="cpu") -> KmerQualStats:
    """``KmerQualStats`` fields (float32 (N,) and (N, k)) -> the port's."""
    return KmerQualStats(total_lq=_as(total_lq, np.float32, device),
                         qual_sum=_as(qual_sum, np.float32, device))


def qual_stats_to_numpy(s: KmerQualStats) -> dict:
    return {"total_lq": s.total_lq.cpu().numpy(),
            "qual_sum": s.qual_sum.cpu().numpy()}


def subclusters_from_numpy(solid, is_center, center_bases, rep,
                           device="cpu") -> SubClusters:
    """``SubClusters`` fields (bool flags, uint8 (N, k) bases, int32 rep)
    -> the port's (int64 rep)."""
    return SubClusters(solid=_as(solid, np.bool_, device),
                       is_center=_as(is_center, np.bool_, device),
                       center_bases=_as(center_bases, np.uint8, device),
                       rep=_as(rep, np.int64, device))


def subclusters_to_numpy(s: SubClusters) -> dict:
    """SubClusters -> {field: numpy array}, rep as the JAX package's
    int32."""
    return {"solid": s.solid.cpu().numpy(),
            "is_center": s.is_center.cpu().numpy(),
            "center_bases": s.center_bases.cpu().numpy(),
            "rep": s.rep.cpu().numpy().astype(np.int32)}


def edge_index_from_numpy(kmers, edge, offset, is_fwd, num, k: int,
                          device="cpu") -> EdgeKmerIndex:
    """The JAX package's ``EdgeKmerIndex`` fields (uint32 (N, W) words,
    int32 edge and offset, bool strand) -> the port's (fused keys)."""
    return EdgeKmerIndex(
        keys=torch.stack(segments.fuse_words(_words(kmers, device))),
        edge=_as(edge, np.int64, device), offset=_as(offset, np.int64, device),
        is_fwd=_as(is_fwd, np.bool_, device), num=_scalar(num, device), k=k)


def edge_index_to_numpy(index) -> dict:
    """EdgeKmerIndex -> {kmers: uint32 (N, W), edge, offset: int32,
    is_fwd: bool, num: int, k}."""
    words = segments.unfuse_keys(list(index.keys.unbind(0)),
                                 dna.words_per_kmer(index.k))
    return {"kmers": words.cpu().numpy().astype(np.uint32),
            "edge": index.edge.cpu().numpy().astype(np.int32),
            "offset": index.offset.cpu().numpy().astype(np.int32),
            "is_fwd": index.is_fwd.cpu().numpy(),
            "num": int(index.num), "k": index.k}


def _mapping_from_numpy(cls, arrays: dict, device):
    return cls(**{name: _as(arrays[name], np.bool_ if name == "mapped"
                            else np.int64, device) for name in cls._fields})


def _mapping_to_numpy(m) -> dict:
    return {name: (getattr(m, name).cpu().numpy() if name == "mapped"
                   else getattr(m, name).cpu().numpy().astype(np.int32))
            for name in m._fields}


def read_mapping_from_numpy(arrays: dict, device="cpu"):
    """{oriented_edge, start, votes: int32 (R,), mapped: bool (R,)} (the
    JAX package's ``ReadMapping`` fields) -> the port's."""
    return _mapping_from_numpy(ReadMapping, arrays, device)


def read_mapping_to_numpy(m) -> dict:
    """ReadMapping -> {field: numpy array}, the JAX package's dtypes."""
    return _mapping_to_numpy(m)


def chain_mapping_from_numpy(arrays: dict, device="cpu"):
    """The JAX package's ``ChainMapping`` fields ((R, C) int32 columns,
    (R,) chain_len and mapped) -> the port's."""
    return _mapping_from_numpy(ChainMapping, arrays, device)


def chain_mapping_to_numpy(m) -> dict:
    """ChainMapping -> {field: numpy array}, the JAX package's dtypes."""
    return _mapping_to_numpy(m)


def paired_index_from_numpy(e1, e2, dist, weight, num, var=None,
                            device="cpu"):
    """The JAX package's ``PairedIndex`` fields (int32 e1, e2, dist,
    float32 weight and var, or var None) -> the port's, on ``device``."""
    return PairedIndex(
        e1=_as(e1, np.int64, device), e2=_as(e2, np.int64, device),
        dist=_as(dist, np.int64, device),
        weight=_as(weight, np.float32, device), num=_scalar(num, device),
        var=None if var is None else _as(var, np.float32, device))


def paired_index_to_numpy(idx) -> dict:
    """PairedIndex (on a device or on the host) -> {e1, e2, dist: int32,
    weight, var: float32 or None, num: int}."""
    return host_index(idx)._asdict()


def insert_size_stats_from_numpy(stats: dict):
    """``vars()`` of the JAX package's ``InsertSizeStats`` -> the port's."""
    return InsertSizeStats(**stats)


def insert_size_stats_to_numpy(stats) -> dict:
    """InsertSizeStats -> the dict the JAX package's class is made from."""
    return dict(vars(stats))


def path_set_from_numpy(paths) -> PathSet:
    """Lists of edge ids (the JAX package's ``PathSet.paths``) -> the
    port's PathSet."""
    return PathSet(paths=[[int(e) for e in p] for p in paths])


def path_set_to_numpy(ps) -> list[list[int]]:
    """PathSet -> its lists of edge ids."""
    return [[int(e) for e in p] for p in ps.paths]


HMM_FIELDS = ("match", "tMM", "tMI", "tMD", "tIM", "tII", "tDM", "tDD")


def hmm_profile_from_numpy(name: str, arrays: dict,
                           desc: str = "") -> HMMProfile:
    """{match (m, 21), tMM ... tDD (m,)} float32 arrays -> HMMProfile."""
    return HMMProfile(name=name, desc=desc, **{
        f: np.asarray(arrays[f], np.float32) for f in HMM_FIELDS})


def hmm_profile_to_numpy(profile) -> dict:
    """An HMMProfile of either package -> {match, tMM ... tDD} float32
    arrays."""
    return {f: np.asarray(getattr(profile, f), np.float32)
            for f in HMM_FIELDS}


def long_read_alignments_to_numpy(alignments) -> dict:
    """Long-read alignments of either package -> integer arrays: each
    chained hit's read, edge, read and edge intervals and votes, in
    chain order, and each read's chain length."""
    cols = {name: [] for name in ("read_id", "edge", "read_lo", "read_hi",
                                  "edge_lo", "edge_hi", "votes")}
    for al in alignments:
        for h in al.chain:
            cols["read_id"].append(al.read_id)
            for name in ("edge", "read_lo", "read_hi", "edge_lo",
                         "edge_hi", "votes"):
                cols[name].append(getattr(h, name))
    out = {name: np.asarray(v, np.int64) for name, v in cols.items()}
    out["chain_len"] = np.asarray([len(al.chain) for al in alignments],
                                  np.int64)
    return out
