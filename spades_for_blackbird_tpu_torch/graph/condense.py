"""Unitig condensation by pointer jumping over oriented (k+1)-mer edges.

PyTorch counterpart of the JAX package's ``graph/condense.py``:

1. every unique (k+1)-mer yields two oriented edge instances (forward id
   ``2j``, reverse complement ``2j+1``);
2. an oriented edge links to its unique follower iff the k-mer vertex
   between them has in-degree == out-degree == 1;
3. cycles are detected by reachability doubling and broken at a
   conjugate-symmetric point;
4. chains contract by pred-pointer doubling, giving each oriented edge
   its unitig id and offset; sequences, coverage, endpoints and
   conjugate pairing fall out of segmented scatters.
"""

from __future__ import annotations

import torch

from ..kmers import extension
from ..kmers.counter import KmerTable
from ..ops import dna, segments
from . import pointer_jump
from .graph import FLANKING_RANGE, Graph

# oriented instances whose bases are scattered per step
SCATTER_CHUNK = 1 << 20


def oriented_instances(kp1_table: KmerTable, k: int):
    """Rows 2j = forward (k+1)-mer j, 2j+1 = its reverse complement.

    Returns (ori (O, W1), ovalid (O,)). Palindromic (k+1)-mers are
    self-reverse-complement: both instances are the same edge, which
    would break successor injectivity, so only the forward one is valid.
    """
    E = kp1_table.capacity
    dev = kp1_table.kmers.device
    fwd = kp1_table.kmers
    rev = dna.revcomp_kmers(fwd, k + 1)
    ori = torch.stack([fwd, rev], dim=1).reshape(2 * E, -1)
    e_valid = torch.arange(E, device=dev) < kp1_table.num
    pal = torch.all(fwd == rev, dim=1)
    odd = (torch.arange(2 * E, device=dev) % 2) == 1
    ovalid = torch.repeat_interleave(e_valid, 2) & \
        ~(torch.repeat_interleave(pal, 2) & odd)
    return ori, ovalid


def successors(kp1_table: KmerTable, vt: extension.VertexTable, k: int,
               ori: torch.Tensor, ovalid: torch.Tensor):
    """Successor of every oriented instance over its suffix vertex.

    Returns (succ (O,) with NONE = O, suffix, vidx, sfwd, omask, imask).
    """
    O = ori.shape[0]
    suffix = dna.drop_first_bases(ori, 1, k + 1)   # (O, W) last k bases
    csuf, sfwd = dna.canonicalize_kmers(suffix, k)
    vidx = segments.searchsorted_rows(vt.kmers, csuf)
    del csuf
    omask = extension.oriented_out_mask(vt, vidx, sfwd)
    imask = extension.oriented_in_mask(vt, vidx, sfwd)
    link = (extension.popcount4(omask) == 1) & \
        (extension.popcount4(imask) == 1) & ovalid
    m = omask.to(torch.int64)
    out_base = (m == 2).to(torch.int64) + 2 * (m == 4) + 3 * (m == 8)
    cn, nfwd = dna.canonicalize_kmers(dna.append_base(suffix, k, out_base),
                                      k + 1)
    j2 = segments.searchsorted_rows(kp1_table.kmers, cn)
    del cn
    link = link & (j2 < kp1_table.num)
    succ = torch.where(link, 2 * j2 + (~nfwd).to(torch.int64), O)
    # self-loop guard: an edge must not succeed itself
    succ = torch.where(succ == torch.arange(O, device=succ.device), O, succ)
    return succ, suffix, vidx, sfwd, omask, imask


def build_graph(kp1_table: KmerTable, vt: extension.VertexTable, k: int
                ) -> Graph:
    """Condense the (k+1)-mer multiset into a conjugate-paired unitig graph."""
    O = 2 * kp1_table.capacity
    dev = kp1_table.kmers.device
    ori, ovalid = oriented_instances(kp1_table, k)
    succ, suffix, vidx, sfwd, _, _ = successors(kp1_table, vt, k, ori, ovalid)
    del suffix

    # endpoint vertices (oriented k-mer ids: 2*vidx + (0 fwd / 1 rc))
    cpre, pfwd = dna.canonicalize_kmers(dna.truncate_bases(ori, k + 1, k), k)
    pvidx = segments.searchsorted_rows(vt.kmers, cpre)
    del cpre
    ov_start = 2 * pvidx + (~pfwd).to(torch.int64)
    ov_end = 2 * vidx + (~sfwd).to(torch.int64)

    o_counts = kp1_table.counts[torch.arange(O, device=dev) // 2].to(
        torch.float32)
    return contract_and_materialize(ori, ovalid, succ, o_counts,
                                    ov_start, ov_end, k)


def _scatter_unitig_bases(ori: torch.Tensor, start_pos: torch.Tensor,
                          k: int, flat_cap: int) -> torch.Tensor:
    """Scatter each oriented instance's k+1 bases into the flat sequence
    pool at start_pos[o] + j (dropped where start_pos == flat_cap).

    The O axis goes in chunks of ``SCATTER_CHUNK`` so the (chunk, k+1)
    position and code temporaries stay small; overlapping writes agree,
    so the order is irrelevant.
    """
    O = ori.shape[0]
    dev = ori.device
    out = torch.zeros(flat_cap + 1, dtype=torch.uint8, device=dev)
    j = torch.arange(k + 1, device=dev)
    for lo in range(0, O, SCATTER_CHUNK):
        s = start_pos[lo:lo + SCATTER_CHUNK]
        codes = dna.unpack_kmers(ori[lo:lo + SCATTER_CHUNK], k + 1)
        pos = torch.clamp(s[:, None] + j[None, :], max=flat_cap)
        pos = torch.where(s[:, None] >= flat_cap, flat_cap, pos)
        out[pos] = codes
    return out[:flat_cap]


def contract_and_materialize(ori: torch.Tensor, ovalid: torch.Tensor,
                             succ: torch.Tensor, o_counts: torch.Tensor,
                             ov_start: torch.Tensor, ov_end: torch.Tensor,
                             k: int) -> Graph:
    """Chain contraction + unitig materialization over per-oriented-
    instance tensors.

    ori: (O, W1) oriented (k+1)-mer words; succ: (O,) successor index
    (O = NONE); o_counts: (O,) multiplicity; ov_start/ov_end: (O,)
    oriented junction-vertex ids of each instance's endpoints.
    """
    O = ori.shape[0]
    dev = ori.device
    ar = torch.arange(O, device=dev)

    # chain contraction (conjugate of oriented instance 2j+s is 2j+1-s)
    chains = pointer_jump.contract_chains(succ, ar ^ 1, ovalid)
    rep, off, is_start = chains.rep, chains.off, chains.is_start
    uid_at_start = torch.cumsum(is_start, 0) - 1
    num_unitigs = is_start.sum()
    uid = uid_at_start[rep]
    uid_safe = torch.where(ovalid, uid, O)
    uid_c = torch.clamp(uid, max=O - 1)

    chain_len = segments.drop_scatter(O, uid_safe, off + 1, "amax")
    # float32 sums of integer counts: exact below 2**24, so the order of
    # the atomic adds on the card does not change them
    cov_sum = segments.drop_scatter(O, uid_safe, o_counts)
    # flanking coverage: average multiplicity of the unitig's first
    # FLANKING_RANGE (k+1)-mers
    flank_sum = segments.drop_scatter(
        O, torch.where(off < FLANKING_RANGE, uid_safe, O), o_counts)

    is_last = ovalid & (off == chain_len[uid_c] - 1)
    last_node = segments.drop_scatter(O, torch.where(is_last, uid, O), ar,
                                      "amax")
    start_node = segments.drop_scatter(O, torch.where(is_start, uid, O), ar,
                                       "amax")

    # conjugate unitig: rc of chain(o0..om) = chain(conj(om)..conj(o0))
    conj = uid[torch.clamp(last_node ^ 1, max=O - 1)]

    # sequences: all k+1 bases of every oriented edge at flat position
    # seq_start[uid] + off + j (overlapping writes agree)
    real = ar < num_unitigs
    seq_len = torch.where(real, chain_len + k, 0)
    seq_start = torch.cumsum(seq_len, 0) - seq_len
    flat_cap = O * (k + 1)
    start_pos = torch.where(ovalid, seq_start[uid_c] + off, flat_cap)
    seq_flat = _scatter_unitig_bases(ori, start_pos, k, flat_cap)

    start_v = ov_start[torch.clamp(start_node, max=O - 1)]
    end_v = ov_end[torch.clamp(last_node, max=O - 1)]

    cov = torch.where(chain_len > 0,
                      cov_sum / torch.clamp(chain_len, min=1), 0.0)
    flank = flank_sum / torch.clamp(chain_len, 1, FLANKING_RANGE).to(
        torch.float32)
    return Graph(
        seq_flat=seq_flat,
        seq_start=seq_start,
        seq_len=seq_len,
        cov=torch.where(real, cov, 0.0),
        start_v=torch.where(real, start_v, 0),
        end_v=torch.where(real, end_v, 0),
        conj=torch.where(real, conj, 0),
        alive=real,
        num_edges=num_unitigs,
        k=k,
        flank=torch.where(real, flank, 0.0),
    )
