"""Distributed graph construction: condensation over the mesh.

PyTorch counterpart of the JAX package's ``parallel/condense_dist.py``:

1. **Successor stage**: each rank owns a contiguous block of oriented
   (k+1)-mer instances (global id = the rank's instance offset + local
   id; the offset is twice the (k+1)-mer slots of the ranks before it,
   where the JAX package pads every shard to one size and takes
   ``shard * 2L``). The three table lookups of the single-device builder
   (suffix vertex, prefix vertex, next edge) become *routed queries*
   (``_routed_lookup``): keys go to their hash owner, the owner answers
   from its sorted partition, the answers come back and are put in
   request order. This replaces the reference's shared-memory
   perfect-hash probes (debruijn_graph_constructor.hpp:390-520).
2. **Contraction + materialisation**: the JAX package runs
   ``contract_and_materialize`` under GSPMD with the per-instance arrays
   sharded and lets XLA insert the collectives. The port gathers the
   per-instance arrays to every rank, in rank order (the global id
   order), and every rank runs the port's own ``contract_and_materialize``
   on them: the same graph on every rank, which the replicated
   simplification then takes.

The unitig numbering depends on the partition layout, so a build at
D >= 2 equals the single-device build in canonical form (sorted
canonical sequences, coverage, conjugate pairing); at D = 1 it is the
single-device build.

``contract_chains_sharded`` is ``pointer_jump.contract_chains`` over an
element array split into contiguous blocks, one a rank: every
``x[idx]`` of the pointer jumping is a routed fetch from the blocks'
owners (``_Blocks.fetch``), so no rank holds more than its block.
"""

from __future__ import annotations

import torch

from ..graph import condense
from ..graph.graph import Graph
from ..graph.pointer_jump import Chains
from ..kmers import extension
from ..kmers.counter import KmerTable
from ..kmers.extension import VertexTable
from ..ops import dna, segments
from .kmer_exchange import owner_of
from .mesh import Mesh

MISS = -1


def _routed_lookup(mesh: Mesh, keys: torch.Tensor, valid: torch.Tensor,
                   answer_fn, n_ans: int) -> torch.Tensor:
    """Query rows ``keys`` (N, W) routed to their hash owner and
    answered there: ``answer_fn(rows (M, W)) -> (M, n_ans) int64`` runs
    on the owner against its partition. Returns (N, n_ans) int64 answers
    in request order, ``MISS`` where ``valid`` is false. Two exchanges:
    the queries out, the answers back (``Mesh.reply`` un-permutes)."""
    at = torch.nonzero(valid).flatten()
    q = keys[at]
    got, route = mesh.exchange(q, owner_of(mesh, q))
    back = mesh.reply(answer_fn(got), route)
    out = torch.full((keys.shape[0], n_ans), MISS, dtype=torch.int64,
                     device=keys.device)
    out[at] = back
    return out


def _offsets(mesh: Mesh, n: int) -> list[int]:
    """Exclusive prefix sums of every rank's ``n``, and the total last."""
    sizes = mesh.gather_cat(torch.tensor([n], dtype=torch.int64,
                                         device=mesh.device)).tolist()
    out = [0]
    for s in sizes:
        out.append(out[-1] + s)
    return out


def make_sharded_graph_builder(mesh: Mesh, k: int):
    """``build(kp1, vt) -> Graph``: this rank's partitions of the
    (k+1)-mer table (``make_sharded_counter``) and of the vertex table
    (``make_sharded_vertex_builder``) in; the condensed unitig graph,
    the same on every rank, out (table-capacity sized, as
    ``condense.build_graph`` returns it: ``compact_graph`` trims it)."""
    def build(kp1: KmerTable, vt: VertexTable) -> Graph:
        L, LV = kp1.capacity, vt.capacity
        inst_off = torch.tensor(_offsets(mesh, 2 * L), device=mesh.device)
        v_off = torch.tensor(_offsets(mesh, LV), device=mesh.device)
        NONE = int(inst_off[-1])
        g_o = inst_off[mesh.rank] + torch.arange(2 * L, device=mesh.device)

        ori, ovalid = condense.oriented_instances(kp1, k)
        suffix = dna.drop_first_bases(ori, 1, k + 1)
        csuf, sfwd = dna.canonicalize_kmers(suffix, k)
        cpre, pfwd = dna.canonicalize_kmers(
            dna.truncate_bases(ori, k + 1, k), k)

        def vt_answer(q):
            i = segments.searchsorted_rows(vt.kmers, q)
            found = i < vt.num
            i_safe = torch.clamp(i, max=LV - 1)
            return torch.stack([
                torch.where(found, i, MISS),
                torch.where(found, vt.out_mask[i_safe].to(torch.int64), 0),
                torch.where(found, vt.in_mask[i_safe].to(torch.int64), 0),
            ], dim=1)

        # suffix and prefix vertices in one routed lookup
        ans = _routed_lookup(mesh, torch.cat([csuf, cpre]),
                             torch.cat([ovalid, ovalid]), vt_answer, 3)
        O = 2 * L
        suf_ans, pre_ans = ans[:O], ans[O:]
        suf_found, pre_found = suf_ans[:, 0] != MISS, pre_ans[:, 0] != MISS
        suf_vidx = torch.where(
            suf_found, v_off[owner_of(mesh, csuf)] + suf_ans[:, 0], 0)
        pre_vidx = torch.where(
            pre_found, v_off[owner_of(mesh, cpre)] + pre_ans[:, 0], 0)
        del ans, csuf, cpre, pre_ans

        omask_raw = suf_ans[:, 1].to(torch.uint8)
        imask_raw = suf_ans[:, 2].to(torch.uint8)
        omask = torch.where(sfwd, omask_raw, extension.reverse4(imask_raw))
        imask = torch.where(sfwd, imask_raw, extension.reverse4(omask_raw))
        link = ((extension.popcount4(omask) == 1)
                & (extension.popcount4(imask) == 1) & ovalid & suf_found)
        m = omask.to(torch.int64)
        out_base = (m == 2).to(torch.int64) + 2 * (m == 4) + 3 * (m == 8)
        cn, nfwd = dna.canonicalize_kmers(
            dna.append_base(suffix, k, out_base), k + 1)
        del suffix, suf_ans

        def edge_answer(q):
            j = segments.searchsorted_rows(kp1.kmers, q)
            return torch.where(j < kp1.num, j, MISS)[:, None]

        edge_ans = _routed_lookup(mesh, cn, link, edge_answer, 1)[:, 0]
        link = link & (edge_ans != MISS)
        succ = torch.where(
            link, inst_off[owner_of(mesh, cn)] + 2 * edge_ans
            + (~nfwd).to(torch.int64), NONE)
        succ = torch.where(succ == g_o, NONE, succ)   # self-loop guard
        del cn, edge_ans

        ov_start = 2 * pre_vidx + (~pfwd).to(torch.int64)
        ov_end = 2 * suf_vidx + (~sfwd).to(torch.int64)
        counts = kp1.counts.to(torch.int64).repeat_interleave(2)
        W1 = ori.shape[1]
        inst = mesh.gather_cat(torch.cat([
            ori, ovalid.to(torch.int64)[:, None], succ[:, None],
            counts[:, None], ov_start[:, None], ov_end[:, None]], dim=1))
        del ori, ovalid, succ, counts, ov_start, ov_end
        return condense.contract_and_materialize(
            inst[:, :W1].contiguous(), inst[:, W1] != 0,
            inst[:, W1 + 1].contiguous(), inst[:, W1 + 2].to(torch.float32),
            inst[:, W1 + 3].contiguous(), inst[:, W1 + 4].contiguous(), k)
    return build


class _Blocks:
    """An element array split into contiguous blocks, one a rank: routed
    reads of other ranks' blocks by global index."""

    def __init__(self, mesh: Mesh, n_local: int):
        self.mesh = mesh
        offs = _offsets(mesh, n_local)
        self.n = offs[-1]
        self.lo = offs[mesh.rank]
        self.starts = torch.tensor(offs[1:-1], dtype=torch.int64,
                                   device=mesh.device)
        self.idx = self.lo + torch.arange(n_local, device=mesh.device)

    def owner(self, idx: torch.Tensor) -> torch.Tensor:
        return torch.bucketize(idx.contiguous(), self.starts, right=True)

    def fetch(self, cols: list[torch.Tensor], idx: torch.Tensor,
              fill: list[int]) -> list[torch.Tensor]:
        """``[c[idx] for c in cols]`` with every c the global array whose
        block this rank holds; ``fill`` where ``idx`` is ``n`` (NONE)."""
        ok = idx < self.n
        at = torch.nonzero(ok).flatten()
        q = idx[at]
        got, route = self.mesh.exchange(q, self.owner(q))
        local = torch.stack(cols, dim=1)[got - self.lo]
        back = self.mesh.reply(local, route)
        out = []
        for j, f in enumerate(fill):
            col = torch.full_like(idx, f)
            col[at] = back[:, j]
            out.append(col)
        return out


def contract_chains_sharded(mesh: Mesh, succ: torch.Tensor,
                            conj: torch.Tensor,
                            valid: torch.Tensor) -> Chains:
    """``pointer_jump.contract_chains`` with the element array split over
    the ranks: each rank passes its contiguous block of the global
    (N,) arrays (``succ`` and ``conj`` global ids, N = NONE) and gets
    its block of the result back, equal to the single-device result."""
    b = _Blocks(mesh, succ.shape[0])
    N = NONE = b.n
    idx = b.idx
    n_rounds = max(1, N.bit_length())

    # pred[succ[i]] = i: each (succ[i], i) goes to succ[i]'s owner
    has = succ < N
    pairs = torch.stack([succ[has], idx[has]], dim=1)
    got, _ = mesh.exchange(pairs, b.owner(pairs[:, 0]))
    pred = torch.full_like(idx, NONE)
    pred[got[:, 0] - b.lo] = got[:, 1]

    # cycle detection: doubling; NONE absorbs chains
    reach = succ
    for _ in range(n_rounds):
        reach, = b.fetch([reach], reach, [NONE])
    cyclic = (reach != NONE) & valid

    # conjugate-symmetric cycle break (pointer_jump.contract_chains)
    bk = torch.where(cyclic, torch.minimum(idx, conj), N)
    ba = idx
    nx = succ
    for _ in range(n_rounds):
        ok, oa, nn = b.fetch([bk, ba, nx], nx, [N, NONE, NONE])
        take = (ok < bk) | ((ok == bk) & (oa < ba))
        bk, ba = torch.where(take, ok, bk), torch.where(take, oa, ba)
        nx = nn
    a = torch.clamp(ba, max=N - 1)
    conj_a, succ_a = b.fetch([conj, succ], a, [0, NONE])
    start_of_cycle = torch.where(a < conj_a, a, succ_a)
    pred = torch.where(cyclic & (idx == start_of_cycle), NONE, pred)

    # chain contraction by pred doubling
    par = torch.where(pred == NONE, idx, pred)
    dist = (pred != NONE).to(torch.int64)
    for _ in range(n_rounds):
        par_par, dist_par = b.fetch([par, dist], par, [0, 0])
        par, dist = par_par, dist + dist_par
    return Chains(rep=par, off=dist, is_start=(pred == NONE) & valid,
                  cyclic=cyclic)
