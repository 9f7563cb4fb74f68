"""The harness end to end at the test size on the CPU's plain paths: the
contract's line, new files found by name, the controls and the faults
each judged not correct.

These call the harness below ``run.py``'s look for a card (``run.py``
itself exits 1 without one), on ``device="cpu"``."""

from __future__ import annotations

import ast
import glob
import json
import os
import shutil

import pytest
import torch

from portbench_tiny import REPO, make_tiny, write_json
from portbench import harness

SEED = 2**31 + 77   # larger than 32 signed bits hold
CELL_CLI = "isolate_pe40_default"
CELL_EC = "isolate_pe40_correction"


def line_of(result, capsys) -> dict:
    harness.print_result(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert err.strip().splitlines()[-1].startswith("check ")
    return line


def run_tiny(root, cell, traced=False, seconds=1.0):
    return harness.run(root, cell, SEED, seconds, traced, device_name="cpu")


def test_correction_cell_prints_the_contract_line(tiny_root, capsys):
    line = line_of(run_tiny(tiny_root, CELL_EC), capsys)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"corrected_reads_per_s", "setup_s"}
    assert line["device"]["platform"] == "cpu"
    assert list(line)[-1] == "checks"
    traced = line_of(run_tiny(tiny_root, CELL_EC, traced=True), capsys)
    assert {"hammer_subcluster_s", "hammer_count_s"} <= set(
        traced["metrics"])
    assert "breakdown" in traced and "busy_s" in traced["device"]


def test_assembly_cell_prints_the_contract_line(tiny_root, capsys):
    line = line_of(run_tiny(tiny_root, CELL_CLI), capsys)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"assembly_s", "ng50_kb", "setup_s"}
    assert set(line["checks"]) == {"missing_share", "contig_foreign_per_mb",
                                   "scaffold_foreign_per_mb", "coverage_gap"}


def test_new_cell_metric_and_check_are_found_by_name(tmp_path, capsys):
    root = make_tiny(str(tmp_path))
    bench_path = os.path.join(str(tmp_path), "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "new_cell", "config":
                               "ecoli_isolate_pe100", "traffic": "new_mix",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "jobs_done", "unit": "jobs",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["new_cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "corrected_reads_per_s":
            m["workloads"].append("new_cell")
    write_json(bench_path, bench)
    shutil.copy(os.path.join(root, "traffic", "correct_reads_k21.json"),
                os.path.join(root, "traffic", "new_mix.json"))
    write_json(os.path.join(root, "cells", "new_cell.json"),
               {"limits": {"wrong_after_share": 0.3, "jobs_left": 0}})
    with open(os.path.join(root, "metrics", "jobs_done.py"), "w") as f:
        f.write("def read(run):\n    return run.jobs\n")
    with open(os.path.join(root, "checks", "jobs_left.py"), "w") as f:
        f.write("def reading(run):\n    return 0\n")
    line = line_of(harness.run(root, "new_cell", 5, 1.0, False, "cpu"),
                   capsys)
    assert line["correct"] is True
    assert {"jobs_done", "corrected_reads_per_s", "setup_s"} == set(
        line["metrics"])
    assert line["checks"]["jobs_left"] == {"value": 0, "limit": 0}


def load_control(root):
    return harness.load_module(os.path.join(root, "control.py"),
                               "portbench_control_copy")


def test_controls_are_not_correct(tiny_root):
    control = load_control(tiny_root)
    for cell, names in ((CELL_EC, ("uncorrected",)),
                        (CELL_CLI, ("substituted", "quarter_pairs"))):
        out = control.main(["--workload", cell, "--seeds", "3", "--device",
                            "cpu", "--controls", "substituted,quarter_pairs"])
        (rec,) = out["seeds"]
        assert rec["sound"]["correct"] is True, rec
        for name in names:
            assert rec[name]["correct"] is False, (name, rec)


def broken(monkeypatch, module, name, make):
    original = getattr(module, name)
    monkeypatch.setattr(module, name, make(original))


def ec_unchanged(real):
    return lambda codes, lengths, **kw: (codes.clone(), {})


def ec_half(real):
    def half(codes, lengths, **kw):
        n = codes.shape[0] // 2
        kw["quals"] = kw["quals"][:n]
        fixed, stats = real(codes[:n], lengths[:n], **kw)
        return torch.cat([fixed, codes[n:]]), stats
    return half


def ec_altered(real):
    def altered(codes, lengths, **kw):
        fixed, stats = real(codes, lengths, **kw)
        fixed = fixed.clone()
        fixed[:, 0] = (fixed[:, 0] + 1) % 4   # a base of every answer
        return fixed, stats
    return altered


@pytest.mark.parametrize("fault", [ec_unchanged, ec_half, ec_altered])
def test_corrector_faults_are_not_correct(tiny_root, monkeypatch, fault):
    from spades_for_blackbird_tpu_torch.hammer import correct
    broken(monkeypatch, correct, "correct_reads", fault)
    result = run_tiny(tiny_root, CELL_EC)
    assert result["correct"] is False, result["checks"]


def cli_unchanged(monkeypatch):
    """The error-correction step hands its reads on unchanged."""
    from spades_for_blackbird_tpu_torch.pipeline import spades_stages
    monkeypatch.setattr(spades_stages.hammer_correct, "correct_reads",
                        lambda codes, lengths, **kw: (codes, {}))


def cli_half(monkeypatch):
    """Read conversion keeps half of the pairs."""
    from spades_for_blackbird_tpu_torch.io import fastq
    real = fastq.load_paired_reads

    def half(*a, **kw):
        b1, b2 = real(*a, **kw)
        n = b1.num_reads // 2
        cut = lambda b: fastq.ReadBatch(b.codes[:n], b.lengths[:n], None,
                                        None if b.quals is None
                                        else b.quals[:n])
        return cut(b1), cut(b2)
    monkeypatch.setattr(fastq, "load_paired_reads", half)


def cli_altered(monkeypatch):
    """The contig writer changes a base in every 2 kb it writes."""
    from spades_for_blackbird_tpu_torch.io import fasta
    real = fasta.write_contigs_fasta

    def altered(path, contigs, *a, **kw):
        swap = str.maketrans("ACGT", "CGTA")
        out = [("".join(ch.translate(swap) if i % 2000 == 999 else ch
                        for i, ch in enumerate(s)), c) for s, c in contigs]
        return real(path, out, *a, **kw)
    monkeypatch.setattr(fasta, "write_contigs_fasta", altered)


@pytest.mark.parametrize("fault", [cli_unchanged, cli_half, cli_altered])
def test_assembly_faults_are_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    result = run_tiny(tiny_root, CELL_CLI)
    assert result["correct"] is False, result["checks"]


FORBIDDEN_IMPORTS = ("jax", "jaxlib", "flax", "spades_for_blackbird_tpu",
                     "spades_for_blackbird_tpu_torch")


def imported_roots(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    files = (glob.glob(os.path.join(REPO, "portbench", "reference", "*.py"))
             + glob.glob(os.path.join(REPO, "portbench", "checks", "*.py"))
             + [os.path.join(REPO, "portbench", p) for p in
                ("judge.py", "simulate.py", "kernels.py")])
    for path in files:
        assert not imported_roots(path) & set(FORBIDDEN_IMPORTS), path


def test_no_file_imports_jax():
    for path in glob.glob(os.path.join(REPO, "portbench", "**", "*.py"),
                          recursive=True):
        assert not imported_roots(path) & set(FORBIDDEN_IMPORTS[:4]), path


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "spades_for_blackbird_tpu_torch.x",
                        object())
    monkeypatch.setitem(sys.modules, "spades_for_blackbird_tpu.ops", object())
    found = harness.forbidden_modules()
    assert "spades_for_blackbird_tpu.ops" in found
    assert "spades_for_blackbird_tpu_torch.x" not in found
