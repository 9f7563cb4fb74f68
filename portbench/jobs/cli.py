"""Job kind ``cli``: the port's command line on the configuration's paired
library, from gzip FASTQ files to contigs and scaffolds.

Set-up writes the two mates (gzip level 1) under the run's temporary
directory and runs one warm-up job on the same command over a small
simulation of the configuration (cut by the traffic's ``warmup_scale``),
so that the libraries load and the lazy initialisation happens outside
the window. A job
runs ``cli.main`` into a directory of its own, keeps the text of
``contigs.fasta`` and ``scaffolds.fasta`` and deletes the directory.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys

from portbench import simulate


@contextlib.contextmanager
def quiet(path: str):
    """The command line's console output (both streams, at the file
    descriptors) into ``path`` for the block."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = [os.dup(1), os.dup(2)]
    with open(path, "ab") as f:
        os.dup2(f.fileno(), 1)
        os.dup2(f.fileno(), 2)
    try:
        yield
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        for fd, old in zip((1, 2), saved):
            os.dup2(old, fd)
            os.close(old)


def tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, 2)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


class Job:
    def __init__(self, run, tmp: str):
        self.run = run
        self.tmp = tmp
        self.traffic = run.cell.traffic
        self.mates: list[str] = []

    def argv(self, mates, out: str) -> list[str]:
        argv = ["-1", mates[0], "-2", mates[1], "-o", out]
        argv += list(self.traffic.get("argv", []))
        if self.run.device.type == "cpu":
            argv += ["--device", "cpu"]
        return argv

    def prepare(self) -> None:
        d = os.path.join(self.tmp, "in")
        os.makedirs(d)
        self.mates = simulate.write_mates(self.run.reads, d)

    def _main(self, mates, out: str) -> dict:
        from spades_for_blackbird_tpu_torch import cli
        console = out + ".console"
        with quiet(console):
            rc = cli.main(self.argv(mates, out))
        if rc != 0:
            sys.stderr.write(tail(console))
            raise RuntimeError(f"cli.main returned {rc}")
        texts = {}
        for name in ("contigs", "scaffolds"):
            with open(os.path.join(out, f"{name}.fasta")) as f:
                texts[name] = f.read()
        shutil.rmtree(out)
        os.remove(console)
        return texts

    def warm_up(self) -> None:
        scale = self.traffic.get("warmup_scale")
        if not scale:
            return
        small = simulate.simulate(self.run.cell.config, self.run.seed, scale)
        d = os.path.join(self.tmp, "warm")
        os.makedirs(d)
        mates = simulate.write_mates(small, d)
        self._main(mates, os.path.join(self.tmp, "warm_out"))
        shutil.rmtree(d)

    def run_one(self, i: int) -> dict:
        return self._main(self.mates, os.path.join(self.tmp, f"job_{i}"))

    def release(self) -> None:
        import torch
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()
