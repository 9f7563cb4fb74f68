#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the machine it is started on.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the port (``spades_for_blackbird_tpu_torch``). It needs as many CUDA cards
as the cell asks for and exits 1 without them. It prints the card's name
and power limit on standard error, the compared numbers beside their
limits as the last lines there, and one JSON object as the last line of
standard output. It exits 1 and prints no result where a module whose
top-level name is ``jax``, ``jaxlib``, ``flax`` or
``spades_for_blackbird_tpu`` was imported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
# kernel caches at fixed paths inside the checkout, should anything use them
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1

    from portbench import harness
    info = harness.card()
    harness.log(f"card: {info['kind']} x {info['count']}; nvidia-smi: "
                f"{info['smi']}")
    try:
        result = harness.run(HERE, args.workload, args.seed, args.seconds,
                             bool(args.trace))
    except Exception:
        traceback.print_exc()
        return 1
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules the benchmark must not load were loaded: {bad}",
              file=sys.stderr)
        return 1
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
