"""The benchmark's run: set-up, the measured window, the check, the line.

Everything that belongs to one cell, configuration, traffic mix, job
kind, compared number or metric lives in a file of its own, found by the
name ``BENCHMARK.json`` gives it:

    portbench/cells/<workload>.json     configuration, traffic, limits
    portbench/configs/<config>.json     the deployment (BENCHMARK.json's file)
    portbench/traffic/<traffic>.json    the job mix: job kind and its options
    portbench/jobs/<job>.py             a job kind: set-up, one job, release
    portbench/checks/<number>.py        one compared number's reading
    portbench/metrics/<metric>.py       one metric's reader

Jobs run in a closed loop, one at a time, back to back: the next starts
only if, at the mean job time so far, it would end within the window's
seconds; at least one runs. Rates and times cover the whole window.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

from . import simulate
from .readers import busy_seconds
from .trace import LaunchRecorder, SpanCollector, Trace, device_profiler

FORBIDDEN = ("jax", "jaxlib", "flax", "spades_for_blackbird_tpu")


def load_module(path: str, name: str):
    """Import one file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


@dataclass
class Cell:
    """One workload with everything its name leads to."""
    name: str
    bench: dict            # the whole BENCHMARK.json
    entry: dict            # its workloads entry
    spec: dict             # cells/<name>.json
    config: dict           # configs/<config>.json
    traffic: dict          # traffic/<traffic>.json
    root: str              # the benchmark's folder

    @classmethod
    def load(cls, root: str, name: str):
        bench = read_json(os.path.join(os.path.dirname(root),
                                       "BENCHMARK.json"))
        entry = next(w for w in bench["workloads"] if w["name"] == name)
        cfg_entry = next(c for c in bench["configs"]
                         if c["name"] == entry["config"])
        spec = read_json(os.path.join(root, "cells", f"{name}.json"))
        config = read_json(os.path.join(os.path.dirname(root),
                                        cfg_entry["file"]))
        traffic = read_json(os.path.join(root, "traffic",
                                         f"{entry['traffic']}.json"))
        return cls(name, bench, entry, spec, config, traffic, root)

    def metrics(self, section: str) -> list[dict]:
        """The entries of ``section`` this cell reports."""
        return [m for m in self.bench[section]
                if self.name in m.get("workloads", [self.name])]

    def part(self, kind: str, name: str):
        return load_module(os.path.join(self.root, kind, f"{name}.py"),
                           f"portbench_{kind}_{name}".replace(".", "_"))


@dataclass
class Run:
    """What one run measured, handed to every reader and check."""
    cell: Cell
    seed: int
    device: object
    reads: simulate.Reads
    setup_s: float = 0.0
    window_s: float = 0.0
    jobs: int = 0
    failed: int = 0
    peak_bytes: int = 0
    outputs: list = field(default_factory=list)
    trace: Trace | None = None
    written_bytes: int = 0
    build_s: float = 0.0
    notes: dict = field(default_factory=dict)

    @property
    def kind(self) -> str:
        return self.cell.traffic["kind"]


def process_age_s() -> float:
    """Seconds since this process started (the kernel's own count)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - START


START = time.perf_counter()


def bytes_written() -> int:
    """Bytes this process has handed to write calls so far, files on any
    file system and its own output alike (0 if unknown)."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def card() -> dict:
    """The card's name, power limit and count, as the run reports them."""
    import torch
    smi = ""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "nvidia-smi gave no answer"
    return {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "smi": smi}


def forbidden_modules() -> list[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def build_program() -> None:
    """Build the hand kernels the cells run (nvcc, all at once) and the
    FASTQ reader (g++) into the port's ``build/`` directory inside the
    checkout, or find them there: only a checkout's first run builds."""
    from spades_for_blackbird_tpu_torch import native
    from spades_for_blackbird_tpu_torch.ops import cuda_build, kmer_cuda, seg_sum
    cuda_build.build_all([kmer_cuda.extract_sort_keys.library,
                          seg_sum.seg_sum.library])
    native.get_lib()


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device, tmp: str) -> Run:
    """Set-up, the window and the release of the program's state."""
    import torch
    steps = {}
    if device.type == "cuda":
        t = time.perf_counter()
        build_program()
        steps["build"] = time.perf_counter() - t
    t = time.perf_counter()
    reads = simulate.simulate(cell.config, seed)
    run = Run(cell=cell, seed=seed, device=device, reads=reads)
    job = cell.part("jobs", cell.traffic["job"]).Job(run, tmp)
    steps["simulate"] = time.perf_counter() - t
    written = bytes_written()
    for name, step in (("prepare", job.prepare), ("warm_up", job.warm_up)):
        t = time.perf_counter()
        step()
        steps[name] = time.perf_counter() - t
    run.build_s = steps.get("build", 0.0)
    log(f"set-up: {process_age_s() - sum(steps.values()):.3f} s before "
        "it, " + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items())
        + f"; {bytes_written() - written} bytes written")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    run.trace = Trace(kind=run.kind) if traced else None
    spans = SpanCollector(run.trace) if traced else None
    recorder = None
    written = bytes_written()
    run.setup_s = process_age_s()
    with contextlib.ExitStack() as stack:
        if traced and cuda:
            recorder = LaunchRecorder(device)
            stack.enter_context(device_profiler(run.trace, recorder.side))
            stack.enter_context(recorder)
        t0 = t_end = time.perf_counter()
        while True:
            try:
                with spans.job() if spans else contextlib.nullcontext():
                    run.outputs.append(job.run_one(run.jobs))
                    if cuda:
                        torch.cuda.synchronize(device)
            except Exception as e:  # a failed job ends the window
                run.failed += 1
                log(f"job {run.jobs} failed: {type(e).__name__}: {e}")
                t_end = time.perf_counter()
                break
            run.jobs += 1
            t_end = time.perf_counter()
            if t_end - t0 + (t_end - t0) / run.jobs > seconds:
                break
    run.window_s = t_end - t0
    run.written_bytes = bytes_written() - written
    if cuda:
        run.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if run.trace is not None:
        run.trace.window = (t0, t_end)
        run.trace.jobs = run.jobs
        if recorder:
            run.trace.launches = recorder.launches()
    job.release()
    return run


def check(run: Run) -> tuple[bool, dict]:
    """Each compared number of the cell beside its limit; correct when
    every job ended and every number is within its limit."""
    numbers = {}
    ok = run.failed == 0 and run.jobs > 0
    for name, limit in run.cell.spec["limits"].items():
        value = run.cell.part("checks", name).reading(run)
        numbers[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and value <= limit
    return ok, numbers


def metrics(run: Run, section: str) -> dict:
    out = {}
    for m in run.cell.metrics(section):
        value = run.cell.part("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, by name, and the
    longest idle gaps of the card, each named by the innermost span open
    on the host at its middle."""
    lo, hi = trace.window
    by_name: dict = {}
    for name, s, e in trace.device:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = sorted((max(s, lo), min(e, hi)) for _, s, e in trace.device
                  if e > lo and s < hi)
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        open_spans = [sp for sp in trace.spans if sp[1] <= mid <= sp[2]]
        inner = min(open_spans, key=lambda sp: sp[2] - sp[1],
                    default=["outside_spans"])
        named.append([inner[0], b - a])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}


def run(root: str, workload: str, seed: int, seconds: float, traced: bool,
        device_name: str = "cuda") -> dict:
    """One run of one cell: the contract's result line as a dict."""
    import torch
    cell = Cell.load(root, workload)
    device = torch.device(device_name)
    tmp = tempfile.mkdtemp(prefix="portbench_")
    try:
        run_ = run_cell(cell, seed, seconds, traced, device, tmp)
        section = "per_layer" if traced else "end_to_end"
        line_metrics = metrics(run_, section)
        t = time.perf_counter()
        correct, numbers = check(run_)
        log(f"check: {time.perf_counter() - t:.3f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": run_.peak_bytes}
    result = {"correct": correct, "attempted": run_.jobs + run_.failed,
              "failed": run_.failed, "metrics": line_metrics, "device": dev}
    if traced and run_.trace is not None:
        t = run_.trace
        dev["busy_s"] = busy_seconds(t)
        dev["window_s"] = t.window_s
        result["breakdown"] = breakdown(t)
    log(f"{workload} seed {seed}: {run_.jobs} jobs in {run_.window_s:.3f} s"
        f", set-up {run_.setup_s:.3f} s (the build {run_.build_s:.3f} s "
        f"of it), peak {run_.peak_bytes} bytes, "
        f"{run_.written_bytes} bytes written in the window; the whole run "
        f"{process_age_s():.3f} s")
    # the build's share of setup_s: a checkout's first run compiles
    result["build_s"] = run_.build_s
    result["checks"] = numbers
    return result


def print_result(result: dict) -> None:
    """The checks as the last lines on standard error, the result as the
    last line on standard output."""
    for name, n in result["checks"].items():
        print(f"check {name}: {n['value']} (limit {n['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
