"""Global memory budget (the reference's --memory / -m flag).

The reference turns -m into a hard RLIMIT_AS cap (utils/memory_limit.hpp:14
limit_memory, spades.py:239 default 250 GB). The port sets no such cap: the
budget is what ``StageManager`` holds a stage's peak host RSS against, and
it warns when a stage went past it. Chunks of reads and tables on the card
are sized from the card's free memory (``reads_per_chunk``), not from this
budget.

Set once by the CLI (cli.py --memory); the environment variable
``SFB_MEMORY_GB`` stands in where it was not set.
"""

from __future__ import annotations

import os

import torch

_budget_gb: float | None = None


def set_budget_gb(gb: float | None) -> None:
    global _budget_gb
    _budget_gb = float(gb) if gb else None


def get_budget_gb() -> float | None:
    if _budget_gb is not None:
        return _budget_gb
    env = os.environ.get("SFB_MEMORY_GB")
    return float(env) if env else None


def reads_per_chunk(bytes_per_read: int, device: torch.device,
                    cpu_reads: int, share: int = 4,
                    most: int = 1 << 24) -> int:
    """Rows a chunk holds. On the card, ``1/share`` of its free memory
    over the bytes a row holds at the chunk's peak, rounded down to a
    power of two between 2^12 and ``most``; on the CPU ``cpu_reads``."""
    if device.type != "cuda":
        return cpu_reads
    free, _ = torch.cuda.mem_get_info(device)
    n = max(1 << 12, min(most, free // share // max(bytes_per_read, 1)))
    return 1 << (n.bit_length() - 1)
