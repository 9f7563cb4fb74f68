"""Stage framework with per-stage checkpointing.

PyTorch counterpart of the JAX package's ``pipeline/stages.py``
(the reference's in-process stage pipeline, common/pipeline/stage.hpp:24-194
``StageManager``/``AssemblyStage`` + ``SavesPolicy``, main loop at
pipeline/stage.cpp:143-203, and its ``GraphPack`` container):

- ``PipelineContext`` holds the shared state (reads, graph, libraries,
  genomic info, contigs) and saves/loads itself as npz + json, with the
  JAX package's keys and dtypes, so either package resumes from the
  other's saves;
- ``StageManager.run`` executes stages in order, checkpointing after each
  and resolving ``--continue`` / ``--restart-from`` / ``--stop-after``
  like stage.cpp:49-100 resolves entry points.

The reads and the graph of a context live on the device the run uses
(``codes``/``lengths`` as tensors, uploaded once by read conversion or
``load``); ``save`` brings them to the host.
"""

from __future__ import annotations

import json
import os
import resource
import shutil
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .. import interop
from ..kmers.coverage_model import GenomicInfo
from ..utils import membudget, timetrace
from ..utils.device import resolve_device


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class PipelineContext:
    """The GraphPack: heterogeneous, checkpointable pipeline state."""

    def __init__(self):
        self.codes = None          # (R, L) uint8 tensor (or NumPy array)
        self.lengths = None        # (R,) int32
        self.quals: np.ndarray | None = None      # (R, L) uint8 phred+33
        self.paired_ranges: list[tuple] = []
        # each: (start1, count1, start2, count2, kind) row ranges into
        # codes; kind is "pe" or "mp" (library.hpp LibraryType)
        self.read_length: int = 0
        self.graph = None                          # graph.graph.Graph
        self.genomic_info = None                   # coverage_model.GenomicInfo
        self.contigs: list[tuple[str, float]] = []  # current contig set
        self.final_contigs: list[tuple[str, float]] = []
        self.scaffolds: list[tuple[str, float]] = []
        self.params: dict = {}                     # misc (ks, is_stats, ...)

    # ---- serialization (io/binary/graph_pack.cpp equivalent) ----

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        arrays = {}
        if self.codes is not None:
            arrays["codes"] = _host(self.codes)
            arrays["lengths"] = _host(self.lengths)
            if self.quals is not None:
                arrays["quals"] = _host(self.quals)
        if self.graph is not None:
            for name, value in interop.graph_to_saved_arrays(
                    self.graph).items():
                arrays[f"graph_{name}"] = value
            arrays["graph_k"] = np.asarray(self.graph.k)
        np.savez_compressed(os.path.join(directory, "pack.npz"), **arrays)
        meta = {
            "paired_ranges": self.paired_ranges,
            "read_length": self.read_length,
            "contigs": self.contigs,
            "final_contigs": self.final_contigs,
            "scaffolds": self.scaffolds,
            "params": self.params,
            "genomic_info": (vars(self.genomic_info)
                             if self.genomic_info else None),
        }
        with open(os.path.join(directory, "pack.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, directory: str, device=None) -> "PipelineContext":
        """The context saved in ``directory``, its reads and graph on
        ``device``: the card unless ``"cpu"`` is asked for
        (``resolve_device``)."""
        device = resolve_device(device)
        ctx = cls()
        with np.load(os.path.join(directory, "pack.npz")) as data:
            if "codes" in data:
                ctx.codes = torch.from_numpy(data["codes"]).to(device)
                ctx.lengths = torch.from_numpy(data["lengths"]).to(device)
                if "quals" in data:
                    ctx.quals = data["quals"]
            if "graph_seq_flat" in data:
                arrays = {name: data[f"graph_{name}"]
                          for name in interop.GRAPH_FIELDS
                          if f"graph_{name}" in data}
                ctx.graph = interop.graph_from_numpy(
                    arrays, int(data["graph_k"]), device)
        with open(os.path.join(directory, "pack.json")) as f:
            meta = json.load(f)
        ctx.paired_ranges = [tuple(r) for r in meta["paired_ranges"]]
        ctx.read_length = meta["read_length"]
        ctx.contigs = [tuple(c) for c in meta["contigs"]]
        ctx.final_contigs = [tuple(c) for c in meta["final_contigs"]]
        ctx.scaffolds = [tuple(c) for c in meta.get("scaffolds", [])]
        ctx.params = meta["params"]
        if meta["genomic_info"]:
            ctx.genomic_info = GenomicInfo(**meta["genomic_info"])
        return ctx


@dataclass
class Stage:
    """An assembly stage (stage.hpp:24 AssemblyStage)."""
    name: str
    fn: Callable[[PipelineContext], None]


@dataclass
class StageManager:
    """Runs stages with checkpoint/resume (stage.cpp:143-203).

    checkpoints: "none" | "last" | "all" (SavesPolicy, stage.hpp:156).
    device: where a context loaded from saves puts its reads and graph:
    the card unless ``"cpu"`` is asked for (``resolve_device``).
    """
    stages: list[Stage]
    output_dir: str
    checkpoints: str = "last"
    log: Callable[[str], None] = print
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def saves_dir(self) -> str:
        return os.path.join(self.output_dir, "saves")

    def _checkpoint_file(self) -> str:
        return os.path.join(self.saves_dir, "checkpoint.dat")

    def completed_stage(self) -> str | None:
        try:
            with open(self._checkpoint_file()) as f:
                return f.read().strip() or None
        except FileNotFoundError:
            return None

    def _load(self, stage_name: str) -> PipelineContext:
        return PipelineContext.load(
            os.path.join(self.saves_dir, stage_name), self.device)

    def _entry(self, continue_run: bool, restart_from: str | None
               ) -> tuple[int, int]:
        """(index of the stage the arguments ask to start at, index of the
        stage whose saves the run loads, or -1 for a start from scratch).
        The run starts one past the loaded stage: where the saves of the
        stage before the wanted one are gone it rolls back to the latest
        that has them (stage.cpp:146-180)."""
        names = [s.name for s in self.stages]
        wanted = 0
        if restart_from is not None:
            if restart_from not in names:
                raise ValueError(f"unknown stage {restart_from!r}; "
                                 f"stages: {names}")
            wanted = names.index(restart_from)
        elif continue_run:
            done = self.completed_stage()
            if done in names:
                wanted = names.index(done) + 1
        load_idx = wanted - 1
        while load_idx >= 0 and not os.path.exists(os.path.join(
                self.saves_dir, names[load_idx], "pack.json")):
            load_idx -= 1
        return wanted, load_idx

    def planned(self, continue_run: bool = False,
                restart_from: str | None = None,
                stop_after: str | None = None) -> list[Stage]:
        """The stages ``run`` would execute with these arguments."""
        _, load_idx = self._entry(continue_run, restart_from)
        out = []
        for stage in self.stages[load_idx + 1:]:
            out.append(stage)
            if stage.name == stop_after:
                break
        return out

    def run(self, ctx: PipelineContext, continue_run: bool = False,
            restart_from: str | None = None,
            stop_after: str | None = None) -> PipelineContext:
        names = [s.name for s in self.stages]
        wanted, load_idx = self._entry(continue_run, restart_from)
        if load_idx == len(names) - 1:
            self.log(f"== all stages already complete ({names[-1]})")
            return self._load(names[-1])
        if load_idx >= 0:
            if load_idx != wanted - 1:
                self.log(f"== saves for '{names[wanted - 1]}' missing; "
                         f"rolling back to '{names[load_idx]}'")
            self.log(f"== resuming from saves of stage '{names[load_idx]}'")
            ctx = self._load(names[load_idx])
        elif wanted > 0:
            self.log("== no usable saves; restarting from scratch")

        for stage in self.stages[load_idx + 1:]:
            t0 = time.time()
            self.log(f"== STAGE {stage.name}")
            with timetrace.scope(f"stage:{stage.name}"):
                stage.fn(ctx)
            # peak RSS per stage like the reference's memory reporting
            # (utils/perf/memory.hpp; the manual's per-stage RAM table)
            peak_gb = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
            on_card = ""
            if self.device.type == "cuda":
                # the run's peak so far: a stage that raised it shows
                peak = torch.cuda.max_memory_allocated(self.device)
                on_card = f", device peak {peak / 2**30:.2f} GiB"
            self.log(f"== STAGE {stage.name} done in "
                     f"{time.time()-t0:.1f}s, peak RSS {peak_gb:.2f} GB"
                     f"{on_card}")
            budget = membudget.get_budget_gb()
            if budget and peak_gb > budget:
                # the reference hard-kills on exceeding -m via RLIMIT_AS
                # (utils/memory_limit.hpp:14); here an overrun is reported
                self.log(f"== WARNING: stage {stage.name} peak RSS "
                         f"{peak_gb:.2f} GB exceeds --memory "
                         f"{budget:.0f} GB")
            if timetrace.enabled():
                # dump incrementally so a crash mid-pipeline still
                # leaves the phase breakdown on disk
                timetrace.dump(os.path.join(self.output_dir,
                                            "spades_time_trace.json"))
            if self.checkpoints != "none":
                with timetrace.scope("checkpoint_save", stage=stage.name):
                    ctx.save(os.path.join(self.saves_dir, stage.name))
                with open(self._checkpoint_file(), "w") as f:
                    f.write(stage.name)
                if self.checkpoints == "last":
                    # drop older saves except the previous one
                    idx = names.index(stage.name)
                    for old in names[:max(0, idx - 1)]:
                        old_dir = os.path.join(self.saves_dir, old)
                        if os.path.isdir(old_dir):
                            shutil.rmtree(old_dir)
            if stop_after == stage.name:
                self.log(f"== stopping after stage '{stage.name}'")
                break
        return ctx
