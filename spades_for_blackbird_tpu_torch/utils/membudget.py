"""Global memory budget (the reference's --memory / -m flag).

The reference turns -m into a hard RLIMIT_AS cap (utils/memory_limit.hpp:14
limit_memory, spades.py:239 default 250 GB). The port sets no such cap: the
budget is what ``StageManager`` holds a stage's peak host RSS against, and
it warns when a stage went past it. Counting chunks are sized from the
card's free memory (``kmers/counter.py::chunk_reads_for``), not from this
budget.

Set once by the CLI (cli.py --memory); the environment variable
``SFB_MEMORY_GB`` stands in where it was not set.
"""

from __future__ import annotations

import os

_budget_gb: float | None = None


def set_budget_gb(gb: float | None) -> None:
    global _budget_gb
    _budget_gb = float(gb) if gb else None


def get_budget_gb() -> float | None:
    if _budget_gb is not None:
        return _budget_gb
    env = os.environ.get("SFB_MEMORY_GB")
    return float(env) if env else None
