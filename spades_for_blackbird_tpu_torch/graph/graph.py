"""Condensed de Bruijn graph as flat tensors (edge table).

PyTorch counterpart of the JAX package's ``graph/graph.py``:

- every edge is a unitig with an explicit sequence (ragged rows in one
  flat code buffer);
- vertices are *oriented k-mer ids* ``2*vidx + (0 if forward else 1)``;
  the conjugate of vertex ``v`` is ``v ^ 1`` and the conjugate edge is
  stored explicitly (``conj``);
- deletion is a boolean ``alive`` mask; compaction happens at
  re-condensation points.

All tensors are capacity-padded; ``num_edges`` rows are real.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

# config.info:180 flanking_range
FLANKING_RANGE = 55


@dataclass
class Graph:
    """Edge-table condensed graph (conjugate-paired).

    seq_flat: (FLAT_CAP,) uint8 base codes; edge e's sequence is
      ``seq_flat[seq_start[e] : seq_start[e] + seq_len[e]]``.
    seq_start, seq_len: (E_CAP,) int64; real edges have seq_len >= k+1.
    cov: (E_CAP,) float32 average (k+1)-mer coverage.
    start_v / end_v: (E_CAP,) int64 oriented vertex ids.
    conj: (E_CAP,) int64 conjugate edge id.
    alive: (E_CAP,) bool.
    num_edges: 0-dim int64 tensor.
    k: overlap size between adjacent edges.
    flank: (E_CAP,) float32 average coverage of the first
      min(len-k, FLANKING_RANGE) (k+1)-mers, or None.
    """
    seq_flat: torch.Tensor
    seq_start: torch.Tensor
    seq_len: torch.Tensor
    cov: torch.Tensor
    start_v: torch.Tensor
    end_v: torch.Tensor
    conj: torch.Tensor
    alive: torch.Tensor
    num_edges: torch.Tensor
    k: int
    flank: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.seq_len.shape[0]

    @property
    def device(self) -> torch.device:
        return self.seq_len.device

    def _replace(self, **kw) -> "Graph":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Graph":
        """The graph on ``device`` (itself when it is there already)."""
        device = torch.device(device)
        if self.device == device:
            return self
        return Graph(**{
            f.name: (getattr(self, f.name).to(device)
                     if isinstance(getattr(self, f.name), torch.Tensor)
                     else getattr(self, f.name))
            for f in dataclasses.fields(self)})


def edge_mask(g: Graph) -> torch.Tensor:
    """Alive real edges."""
    return g.alive & (torch.arange(g.capacity, device=g.device)
                      < g.num_edges)


def slot_owner(seq_start: torch.Tensor, m: torch.Tensor,
               flat_cap: int) -> torch.Tensor:
    """Owning edge of every flat sequence slot: (FLAT,) int64, -1 where
    no alive edge's start precedes the slot.

    Relies on the layout invariant (alive edges' seq_start ascend with
    edge id): a dense-ranked start table + vectorised binary search.
    """
    E = seq_start.shape[0]
    dev = seq_start.device
    idx = torch.arange(E, device=dev)
    dest = torch.where(m, torch.cumsum(m, 0) - 1, E)
    dense_start = torch.full((E + 1,), flat_cap, dtype=torch.int64,
                             device=dev)
    dense_start[dest] = torch.where(m, seq_start, flat_cap)
    dense_edge = torch.full((E + 1,), -1, dtype=torch.int64, device=dev)
    dense_edge[dest] = idx
    dense_start, dense_edge = dense_start[:E], dense_edge[:E]
    slots = torch.arange(flat_cap, device=dev)
    lo = torch.zeros(flat_cap, dtype=torch.int64, device=dev)
    hi = torch.full((flat_cap,), E, dtype=torch.int64, device=dev)
    for _ in range(max(1, E.bit_length())):
        mid = (lo + hi) // 2
        right = dense_start[torch.clamp(mid, max=E - 1)] <= slots
        lo, hi = torch.where(right, mid + 1, lo), torch.where(right, hi, mid)
    j = lo - 1
    return torch.where(j >= 0, dense_edge[torch.clamp(j, 0, E - 1)], -1)


def degrees(g: Graph, v_space: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(out_deg, in_deg) int64 tensors of size v_space over alive edges."""
    m = edge_mask(g)
    one = m.to(torch.int64)
    out_deg = torch.zeros(v_space + 1, dtype=torch.int64, device=g.device)
    in_deg = torch.zeros(v_space + 1, dtype=torch.int64, device=g.device)
    out_deg.index_add_(0, torch.where(m, g.start_v, v_space), one)
    in_deg.index_add_(0, torch.where(m, g.end_v, v_space), one)
    return out_deg[:v_space], in_deg[:v_space]


def _pow2_log(n: int, floor: int) -> int:
    return max(floor, int(max(n - 1, 1)).bit_length())


def compact_graph(g: Graph) -> tuple[Graph, int]:
    """Pack alive edges to the front and renumber vertices densely.

    Capacities become power-of-two buckets over the alive edges, the
    vertices they touch and their bases. Conjugate pairing of vertices
    (v <-> v^1) is preserved by remapping vertex PAIRS. Returns
    (graph, new_v_space). Runs on the graph's device; the JAX package
    does this on the host.
    """
    dev = g.device
    ids = torch.nonzero(edge_mask(g)).flatten()
    n = ids.shape[0]
    E2 = 1 << (max(3, int(n - 1).bit_length() if n else 3))
    new_of = torch.full((g.capacity,), E2, dtype=torch.int64, device=dev)
    new_of[ids] = torch.arange(n, device=dev)

    start_v = g.start_v[ids]
    end_v = g.end_v[ids]
    conj = new_of[g.conj[ids]]
    # dense vertex renumbering by conjugate pair
    bases, inv = torch.unique(torch.cat([start_v, end_v]) // 2,
                              return_inverse=True)
    start_v = 2 * inv[:n] + (start_v & 1)
    end_v = 2 * inv[n:] + (end_v & 1)
    n_v = 2 * bases.shape[0]
    v_space = 1 << _pow2_log(n_v, 3)

    lens = g.seq_len[ids]
    total = int(lens.sum())
    FLAT2 = 1 << _pow2_log(total, 4)
    new_start = torch.cumsum(lens, 0) - lens
    owner = torch.repeat_interleave(torch.arange(n, device=dev), lens,
                                    output_size=total)
    src = g.seq_start[ids][owner] + (torch.arange(total, device=dev)
                                     - new_start[owner])
    new_flat = torch.zeros(FLAT2, dtype=torch.uint8, device=dev)
    new_flat[:total] = g.seq_flat[src]

    def padded(x, fill):
        out = torch.full((E2,), fill, dtype=x.dtype, device=dev)
        out[:n] = x
        return out

    g2 = Graph(
        seq_flat=new_flat,
        seq_start=padded(new_start, 0),
        seq_len=padded(lens, 0),
        cov=padded(g.cov[ids], 0.0),
        start_v=padded(start_v, 0),
        end_v=padded(end_v, 0),
        conj=padded(conj, 0),
        alive=torch.arange(E2, device=dev) < n,
        num_edges=torch.tensor(n, dtype=torch.int64, device=dev),
        k=g.k,
        flank=None if g.flank is None else padded(g.flank[ids], 0.0))
    return g2, v_space
