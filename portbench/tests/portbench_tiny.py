"""A copy of the benchmark at a size a test run can hold, for the
benchmark's CPU tests.

Run from the root of the repository:

    python -m pytest portbench/tests -q

The copy's configurations keep every key and shape of the real ones and
cut the sequences (30 kb isolate with two 400 bp repeats, 6,000 pairs at
40x); its limits are set for that size from
readings on the CPU (the real cells' limits are set at full size on the
card, PERF.md)."""

from __future__ import annotations

import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the tiny isolate's readings on the CPU: missing_share 0.024,
# contig_foreign_per_mb 0, scaffold_foreign_per_mb 1,992 (a 55 bp tandem
# copy at each of two scaffold joins), coverage_gap 0.009; the controls:
# substituted 5,166-7,229 and 6,107-6,110, quarter_pairs coverage_gap
# 0.712-0.718
TINY_LIMITS = {
    "isolate_pe40_default": {"missing_share": 0.05,
                             "contig_foreign_per_mb": 1000.0,
                             "scaffold_foreign_per_mb": 4000.0,
                             "coverage_gap": 0.05},
    "isolate_pe40_correction": {"wrong_after_share": 0.3},
}


def write_json(path: str, data) -> None:
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def make_tiny(dest: str) -> str:
    """A copy of BENCHMARK.json and portbench/ under ``dest`` at the test
    size; returns the copy's benchmark folder."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    root = os.path.join(dest, "portbench")
    shutil.copytree(os.path.join(REPO, "portbench"), root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    p = os.path.join(root, "configs", "ecoli_isolate_pe100.json")
    with open(p) as f:
        cfg = json.load(f)
    cfg["sources"][0].update(length=30000, repeats=[[400, 2]])
    cfg["pairs"] = 6000
    write_json(p, cfg)
    p = os.path.join(root, "traffic", "paired_default.json")
    with open(p) as f:
        t = json.load(f)
    t["warmup_scale"] = 0
    write_json(p, t)
    for cell, limits in TINY_LIMITS.items():
        write_json(os.path.join(root, "cells", f"{cell}.json"),
                   {"limits": limits})
    return root
