"""Fixed-shape row chunking.

PyTorch counterpart of the JAX package's ``ops/chunking.py``.
The JAX version slices with a traced offset so that one compile serves
every chunk; eager PyTorch has no compiles, so a slice is a view.
"""

from __future__ import annotations

import torch


def dslice(arr: torch.Tensor, lo: int, chunk: int) -> torch.Tensor:
    """arr[lo:lo+chunk] along dim 0. The caller guarantees lo+chunk <= len."""
    return arr[lo:lo + chunk]


def pad_rows(arr: torch.Tensor, n_rows: int, fill=0) -> torch.Tensor:
    """Pad dim 0 up to ``n_rows`` with ``fill``."""
    pad = n_rows - arr.shape[0]
    if pad <= 0:
        return arr
    tail = torch.full((pad,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                      device=arr.device)
    return torch.cat([arr, tail], dim=0)


def pad_to_multiple(arr: torch.Tensor, chunk: int, fill=0) -> torch.Tensor:
    """Pad dim 0 to a multiple of ``chunk``."""
    n = arr.shape[0]
    return pad_rows(arr, ((n + chunk - 1) // chunk) * chunk, fill)
