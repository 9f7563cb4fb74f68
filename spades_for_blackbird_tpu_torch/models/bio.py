"""biosyntheticSPAdes: domain extraction, restricted edges, domain graph.

PyTorch counterpart of the JAX package's ``models/bio.py``:

- :func:`extract_domains` — ``ExtractDomains``
  (projects/spades/extract_domains.cpp + domain_matcher.cpp:36-110):
  translate every contig in 3 frames on both strands into one ragged
  buffer, score all frames against every profile HMM in one batched
  Viterbi call a group of profiles (``ops/hmm.py``, the kernel
  ``csrc/viterbi.cu`` on a card; one group unless the outputs outgrow
  the card's free memory, a profile a group on the CPU), and write the
  hit subsequences to ``temp_anti/restricted_edges.fasta``
  (domain_matcher.cpp:157-172). Only the rows that reach the score
  threshold come back to the host for the greedy hit selection.
- :func:`fill_restricted_edges` — ``RestrictedEdgesFilling``
  (projects/spades/restricted_edges_filling.cpp:16-41, the blackbird
  fork's edge-masking feature): the edges a set of sequences runs
  through are protected from bulge removal, so an allele or a domain the
  caller asks about survives simplification.
- :func:`build_domain_graph` / :func:`bgc_candidates` /
  :func:`write_bgc_outputs` — ``DomainGraphConstruction``
  (projects/spades/domain_graph_construction.cpp, domain_graph.cpp):
  order domain hits along contigs, connect hits within ``max_gap``, emit
  candidate BGC (biosynthetic gene cluster) chains and their sequences.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..graph.graph import Graph, edge_mask
from ..mapping import index as eidx
from ..mapping import mapper
from ..ops import aa as aa_ops
from ..ops import dna, kmer_cuda
from ..ops import hmm as hmm_ops
from ..utils.device import resolve_device


@dataclass
class DomainHit:
    name: str          # model name
    desc: str
    contig: int        # contig index
    strand: int        # +1 / -1 relative to the contig as given
    nt_start: int      # on the contig's forward strand
    nt_end: int        # exclusive
    score: float
    seq: str           # nucleotide subsequence (forward strand of contig)


# 2-bit codes of a contig's bases as the JAX package reads them: a base
# outside ACGT (either case) counts as A on the forward strand, and its
# complement as T on the reverse one
_FWD_CODE = np.zeros(256, np.uint8)
_RC_CODE = np.full(256, 3, np.uint8)
for _base, _code in zip("ACGT", range(4)):
    for _c in (_base, _base.lower()):
        _FWD_CODE[ord(_c)] = _code
        _RC_CODE[ord(_c)] = 3 - _code


def _strand_codes(seq: str) -> tuple[np.ndarray, np.ndarray]:
    """(forward, reverse-complement) 2-bit codes of a contig."""
    raw = np.frombuffer(seq.encode("ascii", errors="replace"), np.uint8)
    return _FWD_CODE[raw], _RC_CODE[raw][::-1]


def _frames(contigs: list[str]):
    """(contig index, strand, frame, AA codes) of every non-empty
    translated frame, in the JAX package's order."""
    frames = []
    for ci, seq in enumerate(contigs):
        fwd, rc = _strand_codes(seq)
        for strand, codes in ((1, fwd), (-1, rc)):
            for fr in range(3):
                aa_codes = aa_ops.translate_codes(codes, fr)
                if len(aa_codes):
                    frames.append((ci, strand, fr, aa_codes))
    return frames


def frame_rows(frames):
    """The frames' AA codes as one ragged buffer: (residues (N,) uint8,
    row offsets (B,) int64, row lengths (B,) int64)."""
    lengths = np.array([len(f[3]) for f in frames], np.int64)
    flat = np.concatenate([f[3] for f in frames]).astype(np.uint8) \
        if frames else np.zeros(0, np.uint8)
    return flat, np.cumsum(lengths) - lengths, lengths


def extract_domains(contigs: list[str], profiles,
                    score_threshold: float = 20.0,
                    min_model_frac: float = 0.1,
                    output_dir: str | None = None,
                    device=None) -> list[DomainHit]:
    """Match every profile against 3 frames x 2 strands of every contig,
    on ``device`` (``resolve_device``: the card unless ``"cpu"`` is
    asked for).

    The frames are one ragged buffer; each group of profiles (as many as
    the card's free memory holds the outputs of, one on the CPU:
    ``hmm.profiles_per_launch``) is one batched Viterbi call over all of
    them.

    ``min_model_frac``: discard hits spanning less than this fraction of
    the model (domain_matcher.cpp:57 'Fragmented hit' filter uses 1/10).
    """
    frames = _frames(contigs)
    hits: list[DomainHit] = []
    if frames and profiles:
        device = resolve_device(device)
        flat, offsets, lengths = frame_rows(frames)
        seqs = torch.from_numpy(flat).to(device)
        row_off = torch.from_numpy(offsets).to(device)
        row_len = torch.from_numpy(lengths.astype(np.int32)).to(device)
        B, N = len(frames), int(lengths.sum())
        row_of = torch.repeat_interleave(
            torch.arange(B, device=device), row_len)           # (N,)
        group = hmm_ops.profiles_per_launch(N, len(profiles), device)
        for lo in range(0, len(profiles), group):
            part = profiles[lo:lo + group]
            es, st = hmm_ops.viterbi_kernel.batched(
                hmm_ops.pack_profiles(part, device), seqs, row_off, row_len)
            # a row below the threshold everywhere has no hit: only the
            # others come to the host
            row_max = torch.full((len(part), B), -torch.inf,
                                 device=device).scatter_reduce_(
                1, row_of.expand(len(part), N), es, "amax")
            hot = (row_max >= score_threshold).cpu().numpy()
            for k, prof in enumerate(part):
                rows = np.flatnonzero(hot[k])
                if not len(rows):
                    continue
                sel = torch.from_numpy(hot[k]).to(device)[row_of]
                es_h = es[k][sel].cpu().numpy()
                st_h = st[k][sel].cpu().numpy()
                ends = np.cumsum(lengths[rows])
                min_span = max(1, int(min_model_frac * prof.length))
                for i, hi in zip(rows, ends):
                    ci, strand, fr, _ = frames[i]
                    at = hi - lengths[i]
                    for a, b, s in hmm_ops.find_hits(
                            es_h[at:hi], st_h[at:hi], int(lengths[i]),
                            score_threshold, min_span):
                        nt_a = a * 3 + fr
                        nt_b = (b + 1) * 3 + fr
                        clen = len(contigs[ci])
                        if strand < 0:
                            nt_a, nt_b = clen - nt_b, clen - nt_a
                        hits.append(DomainHit(
                            name=prof.name, desc=prof.desc, contig=ci,
                            strand=strand, nt_start=nt_a, nt_end=nt_b,
                            score=float(s), seq=contigs[ci][nt_a:nt_b]))
            del es, st

    if output_dir is not None:
        tdir = os.path.join(output_dir, "temp_anti")
        os.makedirs(tdir, exist_ok=True)
        with open(os.path.join(tdir, "restricted_edges.fasta"), "w") as f:
            for i, h in enumerate(hits):
                f.write(f">{h.name}_{h.contig}_{i}\n{h.seq}\n")
    return hits


def _rows(seqs: list[str], k: int) -> list[str]:
    """The sequences cut into rows of at most ``kmer_cuda.MAX_L`` bases
    that overlap by k - 1, so every k-mer of a sequence lies in a row."""
    stride = kmer_cuda.MAX_L - k + 1
    return [s[lo:lo + kmer_cuda.MAX_L] for s in seqs
            for lo in range(0, len(s) - k + 1, stride)]


def fill_restricted_edges(g: Graph, seqs: list[str]) -> torch.Tensor:
    """Edges ((E,) bool on the graph's device, conjugate-closed) that any
    (k+1)-mer of the sequences maps to (MapSequence().simple_path() over
    restricted_edges.fasta, inserting each edge and its conjugate)."""
    k = g.k
    mask = torch.zeros(g.capacity, dtype=torch.bool, device=g.device)
    seqs = [s for s in seqs if len(s) > k]
    if not seqs:
        return mask
    idx = eidx.build_edge_index(g, k + 1, device=g.device)
    codes, lengths = dna.encode_reads(_rows(seqs, k + 1))
    edge, _, _, found = mapper.map_kmers(
        idx, torch.from_numpy(codes).to(g.device),
        torch.from_numpy(lengths).to(g.device), k + 1)
    edges = edge[found]
    mask[edges] = True
    mask[g.conj[edges]] = True
    return mask & edge_mask(g)


def load_restricted_fasta(path: str) -> list[str]:
    """The sequences of a FASTA file (restricted_edges.fasta); none when
    the file is missing."""
    seqs = []
    if not os.path.exists(path):
        return seqs
    cur = []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                cur = []
            else:
                cur.append(line.strip())
    if cur:
        seqs.append("".join(cur))
    return seqs


def build_domain_graph(hits: list[DomainHit], max_gap: int = 10000):
    """Arcs between consecutive domain hits on the same contig+strand
    within ``max_gap`` nt (domain_graph.cpp connectivity, restricted to
    the resolved-path coordinate space where our hits already live)."""
    arcs = []
    by_key: dict[tuple[int, int], list[int]] = {}
    for i, h in enumerate(hits):
        by_key.setdefault((h.contig, h.strand), []).append(i)
    for idxs in by_key.values():
        idxs.sort(key=lambda i: hits[i].nt_start)
        for a, b in zip(idxs[:-1], idxs[1:]):
            gap = hits[b].nt_start - hits[a].nt_end
            if gap <= max_gap:
                arcs.append((a, b, gap))
    return arcs


def bgc_candidates(hits: list[DomainHit], arcs) -> list[list[int]]:
    """Chains of connected domain hits (candidate gene clusters)."""
    nxt = {}
    has_prev = set()
    for a, b, _ in arcs:
        nxt.setdefault(a, b)
        has_prev.add(b)
    chains = []
    for i in range(len(hits)):
        if i in has_prev or i not in nxt:
            continue
        chain = [i]
        while chain[-1] in nxt:
            chain.append(nxt[chain[-1]])
        chains.append(chain)
    # singletons that belong to no arc still form 1-domain candidates
    in_chain = {i for c in chains for i in c}
    for i in range(len(hits)):
        if i not in in_chain and i not in has_prev:
            chains.append([i])
    return chains


def write_bgc_outputs(output_dir: str, contigs: list[str],
                      hits: list[DomainHit], chains: list[list[int]],
                      min_domains: int = 1) -> int:
    """gene_clusters.fasta + bgc_statistics.txt + domain_graph.dot
    (biosyntheticSPAdes output surface)."""
    n = 0
    with open(os.path.join(output_dir, "gene_clusters.fasta"), "w") as f, \
            open(os.path.join(output_dir, "bgc_statistics.txt"), "w") as s:
        for chain in chains:
            if len(chain) < min_domains:
                continue
            hs = [hits[i] for i in chain]
            ci = hs[0].contig
            lo = min(h.nt_start for h in hs)
            hi = max(h.nt_end for h in hs)
            seq = contigs[ci][lo:hi]
            n += 1
            names = "+".join(h.name for h in hs)
            f.write(f">cluster_{n}_{names}_len_{len(seq)}\n{seq}\n")
            s.write(f"cluster {n}: contig {ci} [{lo},{hi}) "
                    f"domains {names} strand "
                    f"{'+' if hs[0].strand > 0 else '-'}\n")
    with open(os.path.join(output_dir, "domain_graph.dot"), "w") as d:
        d.write("digraph domain_graph {\n")
        for i, h in enumerate(hits):
            d.write(f'  h{i} [label="{h.name}@{h.contig}:'
                    f'{h.nt_start}-{h.nt_end}"];\n')
        for a, b, gap in build_domain_graph(hits):
            d.write(f'  h{a} -> h{b} [label="{gap}"];\n')
        d.write("}\n")
    return n
