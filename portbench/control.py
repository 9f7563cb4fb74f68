#!/usr/bin/env python3
"""The controls of each cell, beside a sound run on the same seed.

    python3 portbench/control.py --workload <name> --seeds 11,22,33 \
        [--out control_<name>.json]

For each seed, one process: the cell's inputs, one sound job through the
timed path, then each control of the cell's job kind, all judged by the
cell's compared numbers. A control breaks one guarantee that the
configuration states, at the step a later change would be tempted to
take:

* ``cli`` cells: ``quarter_pairs`` and ``eighth_pairs`` run the command
  on every fourth or eighth pair only (the guarantee that every read is
  used: a subsampled assembly is faster, loses coverage and leaves
  holes); ``substituted`` and ``substituted_sparse`` plant one
  substitution in 10 kb and one in 200 kb, the error of an unpolished
  consensus, into the sound job's contigs and scaffolds where they are
  written (the guarantee that contigs are exact); each reports how many
  it planted.
* ``correct_reads`` cells: ``uncorrected`` hands the reads back as they
  came (the guarantee that the reads are corrected). Beside it, as a
  reading and not a control, ``no_quality_model_reading``: the corrector
  without the qualities, on its count-based path, which corrects as well
  or better on these reads (so it breaks no guarantee that a number
  sees).

It needs a CUDA card (``--device cpu`` is for the CPU tests) and prints
one JSON object: each seed's readings of each number, sound and control.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import harness, judge  # noqa: E402


def plant(text: str, rng, rate: float) -> tuple[str, int]:
    """FASTA text with substitutions at ``rate`` in its bases (not N),
    and how many were planted."""
    out, planted = [], 0
    for line in text.splitlines(keepends=True):
        if line.startswith(">"):
            out.append(line)
            continue
        b = bytearray(line.encode())
        for i in np.nonzero(rng.random(len(b)) < rate)[0]:
            if chr(b[i]) in "ACGT":
                b[i] = ord("ACGT"[("ACGT".index(chr(b[i]))
                                   + int(rng.integers(1, 4))) % 4])
                planted += 1
        out.append(b.decode())
    return "".join(out), planted


def readings(run) -> dict:
    ok, numbers = harness.check(run)
    return {"correct": ok,
            **{name: n["value"] for name, n in numbers.items()}}


def variant(run, outputs):
    """The run judged on other answers, sharing the reference's tables."""
    other = harness.Run(cell=run.cell, seed=run.seed, device=run.device,
                        reads=run.reads, jobs=len(outputs), outputs=outputs,
                        notes=run.notes)
    return readings(other)


def subsampled(run, job, tmp: str, every: int) -> dict:
    """The command on every ``every``-th pair, judged against all."""
    keep = np.arange(run.reads.pairs) % every == 0
    d = os.path.join(tmp, f"every_{every}")
    os.makedirs(d)
    mates = harness.simulate.write_mates(run.reads, d, keep=keep)
    t0 = time.perf_counter()
    answer = job._main(mates, d + "_out")
    out = variant(run, [answer])
    out["job_s"] = time.perf_counter() - t0
    shutil.rmtree(d)
    return out


def controls_cli(run, job, tmp: str, wanted) -> dict:
    rng = np.random.default_rng(harness.simulate.seed_for(run.seed, 7))
    sound = run.outputs[0]
    out = {}
    for name, rate in (("substituted", 1e-4), ("substituted_sparse", 5e-6)):
        if name in wanted:
            texts = {part: plant(sound[part], rng, rate)
                     for part in ("contigs", "scaffolds")}
            out[name] = variant(run, [{part: t for part, (t, _) in
                                       texts.items()}])
            out[name]["planted"] = {part: n for part, (_, n) in
                                    texts.items()}
    for name, every in (("quarter_pairs", 4), ("eighth_pairs", 8)):
        if name in wanted:
            out[name] = subsampled(run, job, tmp, every)
    return out


def controls_correction(run, job, tmp: str) -> dict:
    import torch
    from spades_for_blackbird_tpu_torch.hammer import correct
    codes, lengths, _ = job.inputs
    t0 = time.perf_counter()
    plain, _ = correct.correct_reads(codes, lengths, k=job.traffic["k"],
                                     quals=None, device=run.device)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    out = {"no_quality_model_reading": variant(run, [{"corrected": plain}])}
    out["no_quality_model_reading"]["job_s"] = time.perf_counter() - t0
    out["uncorrected"] = variant(run, [{"corrected": codes.clone()}])
    return out


def one_seed(cell, seed: int, device, tmp: str, wanted) -> dict:
    import torch
    reads = harness.simulate.simulate(cell.config, seed)
    run = harness.Run(cell=cell, seed=seed, device=device, reads=reads)
    job = cell.part("jobs", cell.traffic["job"]).Job(run, tmp)
    job.prepare()
    job.warm_up()
    t0 = time.perf_counter()
    run.outputs.append(job.run_one(0))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.jobs = 1
    record = {"seed": seed, "job_s": time.perf_counter() - t0,
              "sound": readings(run)}
    if cell.traffic["job"] == "cli":
        record["coverage_gaps"] = sorted(
            judge.coverage_gaps(run, judge.fasta_answers(run)[0][0]))[-5:]
        record.update(controls_cli(run, job, tmp, wanted))
    else:
        record.update(controls_correction(run, job, tmp))
    job.release()
    return record


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out")
    p.add_argument("--device", default="cuda")
    p.add_argument("--controls", default="substituted,substituted_sparse,"
                   "quarter_pairs,eighth_pairs",
                   help="the cli controls to run")
    args = p.parse_args(argv)
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        raise SystemExit(1)
    cell = harness.Cell.load(HERE, args.workload)
    result = {"workload": args.workload, "limits": cell.spec["limits"],
              "seeds": []}
    if device.type == "cuda":
        result["card"] = harness.card()
    for seed in (int(s) for s in args.seeds.split(",")):
        tmp = tempfile.mkdtemp(prefix="portbench_control_")
        try:
            rec = one_seed(cell, seed, device, tmp,
                           set(args.controls.split(",")))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        harness.log(json.dumps(rec))
        result["seeds"].append(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
