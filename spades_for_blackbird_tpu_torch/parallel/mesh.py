"""The device mesh of the multi-device path, over ``torch.distributed``.

PyTorch counterpart of the JAX package's ``parallel/mesh.py``. The JAX
package is single-controller: one process sees every device and
``shard_map`` runs a per-shard body on each. The port is SPMD, one
process a device: every rank runs the same program on its own shard of
the reads, and the collectives of ``Mesh`` replace ``all_to_all``,
``all_gather`` and ``psum``. NCCL carries them between cards, gloo
between CPU processes.

The scaling axes are the JAX package's: reads (data parallel, a
contiguous block of them a rank) and k-mer space (hash-partitioned
ownership, a k-mer's rows routed to the rank ``kmer_hash(words) % D``).

Every data-dependent branch of the sharded paths is decided on a value
reduced across the ranks (``Mesh.any``, ``Mesh.sum``): a rank that
skipped a collective the others enter would hang them all.

Tensors cross the wire as int32, int64 or float32 (gloo refuses
``torch.uint32``); ``Mesh.gather`` widens bool and uint8 to int32 and
narrows them back.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..ops import dna

# dtypes that cross the wire as they are; others are widened to int32
_WIRE = (torch.int32, torch.int64, torch.float32)


class Route(NamedTuple):
    """How ``Mesh.exchange`` sent rows: the stable sort by owner and the
    row counts to and from each rank, which ``Mesh.reply`` reverses."""
    perm: torch.Tensor
    sent: list[int]
    received: list[int]


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the process group: its rank, the world size D
    and the device its shard lives on (``cuda:LOCAL_RANK`` under NCCL,
    the CPU under gloo)."""
    group: object
    rank: int
    size: int
    device: torch.device

    def check_device(self, device) -> None:
        """Raise where an entry point was asked for another device than
        the mesh's: the sharded paths never move to another device."""
        if torch.device(device).type != self.device.type:
            raise ValueError(f"the process group runs on {self.device}, "
                             f"the call asked for {device}")

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        t = t.to(self.device).clone()
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the ranks (``psum``)."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise maximum over the ranks."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def any(self, flag) -> bool:
        """True on every rank iff ``flag`` is true on one of them."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        return bool(self.max(t).item())

    def all(self, flag) -> bool:
        """True on every rank iff ``flag`` is true on all of them."""
        return not self.any(not flag)

    def exchange(self, rows: torch.Tensor,
                 owner: torch.Tensor) -> tuple[torch.Tensor, Route]:
        """Send every row to the rank ``owner`` names; returns the rows
        this rank received (from rank 0's first, each sender's in its
        stable order) and the ``Route`` that ``reply`` reverses.

        The split sizes are exact: an ``all_to_all_single`` of the
        per-destination counts, then one of the rows. Nothing is dropped
        and nothing is padded, so there is no capacity factor to outgrow
        and the run goes on where the JAX package raises on an uneven
        hash."""
        owner = owner.to(torch.int64)
        sent_t = torch.bincount(owner, minlength=self.size)
        recv_t = torch.empty_like(sent_t)
        dist.all_to_all_single(recv_t, sent_t, group=self.group)
        sent, received = sent_t.tolist(), recv_t.tolist()
        perm = torch.sort(owner, stable=True).indices
        out = rows.new_empty((sum(received),) + tuple(rows.shape[1:]))
        dist.all_to_all_single(out, rows[perm].contiguous(), received, sent,
                               group=self.group)
        return out, Route(perm, sent, received)

    def reply(self, answers: torch.Tensor, route: Route) -> torch.Tensor:
        """Send the answers to rows received by ``exchange`` (one a row,
        in the order they were received) back to their senders, and put
        them in the senders' original row order."""
        back = answers.new_empty((sum(route.sent),)
                                 + tuple(answers.shape[1:]))
        dist.all_to_all_single(back, answers.contiguous(), route.sent,
                               route.received, group=self.group)
        out = torch.empty_like(back)
        out[route.perm] = back
        return out

    def gather(self, rows: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``rows`` (ragged along dim 0), in rank order, on
        every rank."""
        n = torch.tensor([rows.shape[0]], dtype=torch.int64,
                         device=self.device)
        sizes = [torch.empty_like(n) for _ in range(self.size)]
        dist.all_gather(sizes, n, group=self.group)
        sizes = [int(s) for s in sizes]
        dtype = rows.dtype
        wire = rows if dtype in _WIRE else rows.to(torch.int32)
        pad = max(sizes) - rows.shape[0]
        if pad:
            wire = torch.cat([wire, wire.new_zeros((pad,)
                                                   + tuple(wire.shape[1:]))])
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire.contiguous(), group=self.group)
        return [p[:s].to(dtype) for p, s in zip(parts, sizes)]

    def gather_cat(self, rows: torch.Tensor) -> torch.Tensor:
        """``gather`` concatenated in rank order."""
        return torch.cat(self.gather(rows))


def make_mesh(group=None) -> Mesh:
    """The mesh of an initialised process group (the default group
    without ``group``). Under NCCL the rank's device is
    ``cuda:LOCAL_RANK`` (0 where the variable is not set: one process a
    node), under gloo the CPU; any other backend, or NCCL without a
    card, raises: the mesh never falls back to another device."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group is initialised")
    backend = dist.get_backend(group)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("an NCCL process group needs a CUDA card")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    elif backend == "gloo":
        device = torch.device("cpu")
    else:
        raise ValueError(f"unsupported process-group backend {backend!r}")
    return Mesh(group=group, rank=dist.get_rank(group),
                size=dist.get_world_size(group), device=device)


def auto_mesh() -> Mesh | None:
    """The mesh of the default process group where one of world size 2
    or more is initialised, else None (the single-device path): the
    port's form of the JAX package's "more than one device visible"."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if dist.get_world_size() < 2:
        return None
    return make_mesh()


def shard_reads(mesh: Mesh, codes: torch.Tensor, lengths: torch.Tensor):
    """This rank's contiguous block of a read batch, on the mesh's
    device: R is padded to a multiple of D with empty reads (code 4,
    length 0), as the JAX package pads it, and rank r takes rows
    [r*R/D, (r+1)*R/D). Returns (codes, lengths, R before padding)."""
    R = codes.shape[0]
    per = -(-R // mesh.size)
    lo, hi = mesh.rank * per, min((mesh.rank + 1) * per, R)
    c = codes[lo:hi].to(mesh.device)
    ln = lengths[lo:hi].to(mesh.device)
    pad = per - c.shape[0]
    if pad:
        c = torch.cat([c, torch.full((pad,) + tuple(c.shape[1:]),
                                     dna.INVALID_CODE, dtype=c.dtype,
                                     device=c.device)])
        ln = torch.cat([ln, ln.new_zeros(pad)])
    return c, ln, R
