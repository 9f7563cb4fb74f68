#!/usr/bin/env python3
"""Time the paired default command of two checkouts of the port, in
turns, on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 ab_paired.py --tree parent=DIR --tree change=. \\
        --order parent,change,change,parent,parent,change [--out FILE]

The reads are ``chip_smoke.py``'s phase 8 simulation (4.6 Mb, seed 7,
40x, 100 bp FR pairs with qualities), written once as two FASTQ files.
Each entry of ``--order`` runs ``cli.main(["-1", f1, "-2", f2,
"--checkpoints", "none", "--trace-time", ...])`` of the named tree's
package in a child process of its own, after that child has built the
tree's kernels, so no build is timed. Printed a run: the command's
wall, and the ``condense`` and ``simplify`` scopes of each rung (the
spans inside each ``stage:k..`` span of the time trace); then the median
of each figure over a tree's runs. The card's name and power limit
(nvidia-smi) come first.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from spades_for_blackbird_tpu_torch import cli
from spades_for_blackbird_tpu_torch.ops import cuda_build, kmer_cuda, align, hmm
libs = [kmer_cuda.extract_sort_keys.library, align.banded_edit_distance.library,
        hmm.viterbi_kernel.library]
try:
    from spades_for_blackbird_tpu_torch.ops import seg_sum
    libs.append(seg_sum.seg_sum.library)
except ImportError:  # a tree from before the ordered sums
    pass
cuda_build.build_all(libs)
for lib in libs:
    lib.load()
torch.cuda.synchronize()
t0 = time.perf_counter()
rc = cli.main(sys.argv[2:])
torch.cuda.synchronize()
print(json.dumps({"rc": rc, "wall_s": time.perf_counter() - t0}))
"""

SCOPES = ("condense", "simplify")


def rung_scopes(trace_path: str) -> dict:
    """{"k21": {"condense": s, "simplify": s}, ...}: each scope's seconds
    inside each rung's stage span."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    rungs = [(ev["name"][len("stage:"):], ev["ts"], ev["ts"] + ev["dur"])
             for ev in events if ev["name"].startswith("stage:k")]
    out = {name: dict.fromkeys(SCOPES, 0.0) for name, _, _ in rungs}
    for ev in events:
        if ev["name"] not in SCOPES:
            continue
        for name, lo, hi in rungs:
            if lo <= ev["ts"] <= hi:
                out[name][ev["name"]] += ev["dur"] / 1e6
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    metavar="NAME=DIR", help="a checkout to time")
    ap.add_argument("--order", required=True,
                    help="comma-separated tree names, one a run")
    ap.add_argument("--out", default=None, help="write the runs as JSON")
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",")
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: ab_paired.py runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    print(chip_smoke.card_name(), flush=True)
    tmp = tempfile.mkdtemp(prefix="ab_paired_")
    try:
        _, codes, _, quals = chip_smoke.simulate_reads(
            chip_smoke.FULL_GENOME, chip_smoke.FULL_COVERAGE,
            chip_smoke.FULL_READ_LEN, seed=7)
        half = codes.shape[0] // 2
        mates = [os.path.join(tmp, f"reads_{m}.fastq") for m in (1, 2)]
        chip_smoke.write_fastq(mates[0], codes[:half], quals[:half])
        chip_smoke.write_fastq(mates[1], codes[half:], quals[half:])
        del codes, quals
        runs = []
        for i, name in enumerate(order):
            out = os.path.join(tmp, f"out_{i}")
            argv = ["-1", mates[0], "-2", mates[1], "--checkpoints", "none",
                    "--trace-time", "-o", out]
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", CHILD,
                 os.path.abspath(trees[name])] + argv,
                capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout[-4000:] + proc.stderr[-4000:],
                      file=sys.stderr)
                raise RuntimeError(f"run {i} ({name}) failed")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            if res["rc"] != 0:
                raise RuntimeError(f"run {i} ({name}): cli.main gave "
                                   f"{res['rc']}")
            res.update(tree=name, scopes=rung_scopes(
                os.path.join(out, "spades_time_trace.json")),
                child_s=time.perf_counter() - t0)
            runs.append(res)
            print(f"[ab] run {i} {name}: wall {res['wall_s']:.3f} s, "
                  + ", ".join(f"{k} {v['condense']:.3f}/{v['simplify']:.3f}"
                              for k, v in res["scopes"].items())
                  + " (condense/simplify s)", flush=True)
            shutil.rmtree(out, ignore_errors=True)
        medians = {}
        for name in trees:
            mine = [r for r in runs if r["tree"] == name]
            if not mine:
                continue
            med = {"wall_s": statistics.median(r["wall_s"] for r in mine)}
            for rung in mine[0]["scopes"]:
                for scope in SCOPES:
                    med[f"{rung}_{scope}_s"] = statistics.median(
                        r["scopes"][rung][scope] for r in mine)
            medians[name] = med
            print(f"[ab] median {name} over {len(mine)} runs: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in med.items()),
                  flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"card": chip_smoke.card_name(), "runs": runs,
                           "medians": medians}, f, indent=1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
