"""Scaffold correction on planted gaps: the port against the JAX package.

Simulates a genome with ``chip_smoke.py``'s planted repeats (3 x 2 kb,
4 x 700 bp, 6 x 400 bp), 40x FR pairs of 100 bp, builds the graph with
the port's ``tools gbuilder -k 55 --min-count 3`` on the CPU, cuts
``--windows`` evenly spaced windows of 30 kb out of the genome with a
100-base N run in the middle of each, and runs ``tools scf-correction``
of both packages on the CPU. Prints how many gaps each filled, whether
their outputs are identical, and for each scaffold whether the
alignment chain of one of its pieces skips an edge (two consecutive
chain edges that share no vertex): ``correct_scaffold`` fills paths only
between pieces, so such a scaffold keeps its N run.

    JAX_PLATFORMS=cpu python scf_gaps_compare.py [--size 600000]

from the root of the repository takes about three minutes at the
default size (the CPU's gbuilder most of it). Its files go to a
temporary directory that it removes.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("SFB_TPU_FORCE_SINGLE_DEVICE", "1")

from spades_for_blackbird_tpu import tools as jtools  # noqa: E402
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import tools  # noqa: E402
from spades_for_blackbird_tpu_torch.graph.from_gfa import (  # noqa: E402
    graph_from_gfa)
from spades_for_blackbird_tpu_torch.graph.host import host_view  # noqa: E402
from spades_for_blackbird_tpu_torch.mapping import long_read  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

REPEATS = [(2000, 3), (700, 4), (400, 6)]
WINDOW, GAP = 30_000, 100


def sequences(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if not line.startswith(">")]


def broken_chains(gfa: str, scaffolds: list[str]) -> list[bool]:
    """Whether a piece of each scaffold aligns to a chain that skips an
    edge (consecutive edges without a shared vertex)."""
    g = graph_from_gfa(gfa, device="cpu")
    hv = host_view(g)
    out = []
    for s in scaffolds:
        pieces = [m.group() for m in re.finditer("[^Nn]+", s)
                  if len(m.group()) > g.k + 2]
        codes, lengths = dna.encode_reads(pieces)
        broken = False
        for al in long_read.align_long_reads(g, codes, lengths,
                                             device="cpu"):
            edges = [h.edge for h in al.chain]
            broken |= any(int(hv.end_v[a]) != int(hv.start_v[b])
                          for a, b in zip(edges[:-1], edges[1:]))
        out.append(broken)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=600_000)
    ap.add_argument("--windows", type=int, default=14)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="scf_gaps_") as d:
        return compare(args, d)


def compare(args, d: str) -> int:
    g = simulate.random_genome(args.size, seed=7, repeats=REPEATS)
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        g, args.size * 40 // 200, read_len=100, insert_mean=300,
        insert_sd=25, error_rate=0.002, seed=8)
    mates = [os.path.join(d, f"r{m}.fq") for m in (1, 2)]
    simulate.write_fastq(mates[0], r1, q1)
    simulate.write_fastq(mates[1], r2, q2)
    gfa = os.path.join(d, "g.gfa")
    assert tools.main(["gbuilder", *mates, "-k", "55", "--min-count", "3",
                       "--gfa", gfa, "--device", "cpu"]) == 0
    scf = os.path.join(d, "scaffolds.fa")
    step = args.size // args.windows
    with open(scf, "w") as f:
        for i in range(args.windows):
            s = g[i * step + 1000:i * step + 1000 + WINDOW]
            mid = len(s) // 2
            f.write(f">s{i}\n{s[:mid]}{'N' * GAP}{s[mid + GAP:]}\n")
    out = {}
    for name, main_fn, extra in (("port", tools.main, ["--device", "cpu"]),
                                 ("jax", jtools.main, [])):
        path = os.path.join(d, f"{name}.fa")
        assert main_fn(["scf-correction", gfa, scf, "-o", path] + extra) == 0
        out[name] = sequences(path)
    jlogger.configure()
    filled = {name: [GAP * "N" not in s for s in seqs]
              for name, seqs in out.items()}
    broken = broken_chains(gfa, sequences(scf))
    print(f"gaps filled: port {sum(filled['port'])}, JAX "
          f"{sum(filled['jax'])} of {args.windows}; outputs identical: "
          f"{out['port'] == out['jax']}")
    print(f"unfilled with a piece chain that skips an edge: "
          f"{sum(b and not f for b, f in zip(broken, filled['port']))} of "
          f"{args.windows - sum(filled['port'])}; filled with one: "
          f"{sum(b and f for b, f in zip(broken, filled['port']))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
