"""Parallel chain contraction over a successor array (pointer jumping).

PyTorch counterpart of the JAX package's ``graph/pointer_jump.py``,
shared by unitig condensation (graph/condense.py), re-condensation
(simplify/recondense.py) and early tip clipping. Every ``fori_loop`` of
the JAX version is a Python loop with the same round count.

The element space is "things that chain" with:
- ``succ``: unique follower or NONE (= N); injective on valid elements;
- ``conj``: conjugate element (an involution), used to break cycles
  conjugate-symmetrically.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Chains(NamedTuple):
    rep: torch.Tensor       # (N,) chain start (representative) per element
    off: torch.Tensor       # (N,) offset within chain (start = 0)
    is_start: torch.Tensor  # (N,) bool
    cyclic: torch.Tensor    # (N,) bool -- element was on a broken cycle


def _append(x: torch.Tensor, value: int) -> torch.Tensor:
    return torch.cat([x, torch.full((1,), value, dtype=x.dtype,
                                    device=x.device)])


def _predecessors(succ: torch.Tensor) -> torch.Tensor:
    """pred[succ[i]] = i; NONE (= N) where nothing points at an element."""
    N = succ.shape[0]
    pred = torch.full((N + 1,), N, dtype=torch.int64, device=succ.device)
    pred[succ] = torch.arange(N, device=succ.device)
    return pred[:N]


def contract_chains(succ: torch.Tensor, conj: torch.Tensor,
                    valid: torch.Tensor) -> Chains:
    """Contract all chains/cycles of the functional graph ``succ``.

    succ: (N,) int64 in [0, N]; N = NONE. Invalid elements must have
      succ == NONE and never be the successor of a valid element.
    conj: (N,) int64 conjugate involution.
    valid: (N,) bool.
    """
    N = succ.shape[0]
    NONE = N
    idx = torch.arange(N, device=succ.device)
    n_rounds = max(1, N.bit_length())
    pred = _predecessors(succ)

    # cycle detection: doubling; NONE absorbs chains
    reach = succ
    for _ in range(n_rounds):
        reach = _append(reach, NONE)[reach]
    cyclic = (reach != NONE) & valid

    # conjugate-symmetric cycle break: key(e) = min(e, conj(e)); per cycle
    # find the argmin e*; start = e* if e* < conj(e*) else succ(e*)
    bk = torch.where(cyclic, torch.minimum(idx, conj), N)
    ba = idx
    nx = succ
    for _ in range(n_rounds):
        ok, oa = _append(bk, N)[nx], _append(ba, NONE)[nx]
        take = (ok < bk) | ((ok == bk) & (oa < ba))
        bk, ba = torch.where(take, ok, bk), torch.where(take, oa, ba)
        nx = _append(nx, NONE)[nx]
    a = torch.clamp(ba, max=N - 1)
    start_of_cycle = torch.where(a < conj[a], a, _append(succ, NONE)[a])
    break_here = cyclic & (idx == start_of_cycle)
    pred = torch.where(break_here, NONE, pred)

    # chain contraction by pred doubling
    par = torch.where(pred == NONE, idx, pred)
    dist = (pred != NONE).to(torch.int64)
    for _ in range(n_rounds):
        par, dist = par[par], dist + dist[par]
    is_start = (pred == NONE) & valid
    return Chains(rep=par, off=dist, is_start=is_start, cyclic=cyclic)


def chain_exclusive_sum(succ: torch.Tensor, is_start: torch.Tensor,
                        valid: torch.Tensor, values: torch.Tensor
                        ) -> torch.Tensor:
    """Per-element exclusive prefix sum of ``values`` along each chain,
    by pred doubling carrying partial sums. ``succ`` must be the
    post-break successor structure consistent with is_start."""
    N = succ.shape[0]
    NONE = N
    idx = torch.arange(N, device=succ.device)
    pred = torch.where(is_start, NONE, _predecessors(succ))
    n_rounds = max(1, N.bit_length())
    par = torch.where(pred == NONE, idx, pred)
    acc = torch.where(pred == NONE, torch.zeros_like(values),
                      values[torch.clamp(pred, max=N - 1)])
    for _ in range(n_rounds):
        par, acc = par[par], acc + acc[par]
    return acc
