"""Repeat resolution: path extension from paired info (exSPAnder).

PyTorch counterpart of ``spades_for_blackbird_tpu/path_extend/resolver.py``.
So far it holds only the extension parameters, which the assembly
configuration carries; the resolver itself comes with the repeat
resolution slice (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PEParams:
    """extension_options (configs/debruijn/pe_params.info:31-38)."""
    single_threshold: float = 0.1     # normalized per-edge support gate
    weight_threshold: float = 0.5     # min final score to extend
    priority_coeff: float = 1.5       # best/competitor separation
    raw_weight_cutoff: float = 2.9    # weight_counter.hpp:251 hard floor
    unique_edge_length: int = 300     # "long unique" edges claimable once
    seed_min_length: int = 0          # seeds = all edges (pe_resolver.cpp:50)
    max_path_edges: int = 10000
    max_junction_visits: int = 8      # short-loop guard
