"""Interactive graph inspector (online_vis equivalent).

PyTorch counterpart of the JAX package's ``vis.py`` (the reference's
online_vis debug REPL
(projects/online_vis: "environments" over loaded saves, neighbourhood
drawing, sequence/position queries, readline loop at
online_vis/main.cpp + standard_vis.hpp).  Loads a GFA (or a pipeline
saves graph) and answers stats / edge / sequence / neighbourhood /
find queries; ``draw`` writes Graphviz dot of a bounded neighbourhood.
The graph is loaded on the session's device (the card unless ``--device
cpu``); the queries read one host copy of it (``graph/host.py``).

Scriptable: commands come from stdin, so it works both interactively
and piped (``echo "stats" | python -m spades_for_blackbird_tpu_torch.tools
vis g.gfa``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .graph import construct
from .graph.from_gfa import graph_from_gfa
from .graph.graph import edge_codes_host
from .graph.host import edge_mask, host_view
from .io.webvis import write_webvis_html
from .ops import dna


class VisSession:
    def __init__(self, device=None):
        self.g = None
        self.names = {}
        self.device = device
        self._hv = (None, None)  # (graph, its host view)

    def host(self):
        """The host view of the session's graph, pulled once a graph."""
        if self._hv[0] is not self.g:
            self._hv = (self.g, host_view(self.g))
        return self._hv[1]

    # --- commands -------------------------------------------------
    def cmd_load(self, path):
        self.g, self.names = graph_from_gfa(path, return_names=True,
                                            device=self.device)
        print(f"loaded {path}: {int(self.g.num_edges)} edges, "
              f"k={self.g.k}")

    def _need(self):
        if self.g is None:
            print("no graph loaded (use: load <gfa>)")
            return True
        return False

    def cmd_stats(self):
        if self._need():
            return
        print(construct.graph_stats(self.g))

    def cmd_edges(self, n="10"):
        if self._need():
            return
        hv = self.host()
        alive = np.nonzero(edge_mask(hv))[0]
        lens = hv.seq_len
        order = alive[np.argsort(-lens[alive])][:int(n)]
        for e in order:
            self._print_edge(int(e))

    def _print_edge(self, e):
        g = self.host()
        name = self.names.get(e, self.names.get(e ^ 1, ""))
        print(f"edge {e} ({name}): len {int(g.seq_len[e])} "
              f"cov {float(g.cov[e]):.1f} "
              f"{int(g.start_v[e])}->{int(g.end_v[e])} "
              f"conj {int(g.conj[e])}")

    def cmd_edge(self, e):
        if self._need():
            return
        self._print_edge(int(e))

    def cmd_seq(self, e, start="0", end=None):
        if self._need():
            return
        codes = edge_codes_host(self.host(), int(e))
        s = dna.decode_codes(codes)
        end = len(s) if end is None else int(end)
        print(s[int(start):end])

    def _neighborhood(self, e, depth):
        hv = self.host()
        alive = edge_mask(hv)
        start_v, end_v = hv.start_v, hv.end_v
        touch: dict[int, list[int]] = {}
        for x in np.nonzero(alive)[0]:
            touch.setdefault(int(start_v[x]), []).append(int(x))
            touch.setdefault(int(end_v[x]), []).append(int(x))
        sel = {int(e)}
        frontier = {int(e)}
        for _ in range(depth):
            nxt = set()
            for x in frontier:
                for v in (int(start_v[x]), int(end_v[x])):
                    for y in touch.get(v, []):
                        if y not in sel:
                            nxt.add(y)
            sel |= nxt
            frontier = nxt
        return sel

    def cmd_neigh(self, e, depth="1"):
        if self._need():
            return
        for x in sorted(self._neighborhood(int(e), int(depth))):
            self._print_edge(x)

    def cmd_draw(self, e, depth="1", out="neigh.dot"):
        if self._need():
            return
        g = self.host()
        sel = self._neighborhood(int(e), int(depth))
        with open(out, "w") as f:
            f.write("digraph g {\n")
            for x in sorted(sel):
                f.write(f'  v{int(g.start_v[x])} -> v{int(g.end_v[x])} '
                        f'[label="e{x} l={int(g.seq_len[x])} '
                        f'c={float(g.cov[x]):.0f}"];\n')
            f.write("}\n")
        print(f"wrote {out} ({len(sel)} edges)")

    def cmd_find(self, pattern):
        """Locate a DNA string on the graph (positions handler query)."""
        if self._need():
            return
        hv = self.host()
        alive = np.nonzero(edge_mask(hv))[0]
        hits = 0
        for e in alive:
            s = dna.decode_codes(edge_codes_host(hv, int(e)))
            at = s.find(pattern.upper())
            if at >= 0:
                print(f"edge {int(e)} offset {at}")
                hits += 1
        if not hits:
            print("not found")

    def cmd_html(self, out="graph.html"):
        """Standalone interactive HTML view (webvis equivalent)."""
        if self._need():
            return
        write_webvis_html(out, self.host())
        print(f"wrote {out}")

    def cmd_help(self):
        print("commands: load <gfa> | stats | edges [n] | edge <id> | "
              "seq <id> [a b] | neigh <id> [depth] | "
              "draw <id> [depth] [out.dot] | html [out.html] | "
              "find <dna> | quit")

    # --- loop -----------------------------------------------------
    def run(self, stream=None) -> int:
        stream = stream or sys.stdin
        interactive = stream is sys.stdin and sys.stdin.isatty()
        while True:
            if interactive:
                sys.stdout.write("vis> ")
                sys.stdout.flush()
            line = stream.readline()
            if not line:
                break
            toks = line.split()
            if not toks:
                continue
            cmd, args = toks[0], toks[1:]
            if cmd in ("quit", "exit"):
                break
            fn = getattr(self, f"cmd_{cmd}", None)
            if fn is None:
                print(f"unknown command {cmd!r} (try: help)")
                continue
            try:
                fn(*args)
            except Exception as ex:  # keep the REPL alive on bad input
                print(f"error: {ex}")
        return 0


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="vis")
    p.add_argument("graph_gfa", nargs="?", default=None)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    sess = VisSession(device=a.device)
    if a.graph_gfa:
        sess.cmd_load(a.graph_gfa)
    return sess.run()
