"""The PyTorch port's command line vs the JAX package's: the same FASTQ
file through both, checkpoints and resumes, what the port refuses, and
the logger it leaves behind."""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from spades_for_blackbird_tpu import cli as jcli  # noqa: E402
from spades_for_blackbird_tpu.pipeline import stages as jstages  # noqa: E402
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import cli  # noqa: E402
from spades_for_blackbird_tpu_torch.io import fastq, gfa  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import (  # noqa: E402
    spades_stages, stages)
from spades_for_blackbird_tpu_torch.pipeline.config import (  # noqa: E402
    MODES, config_for_mode)
from spades_for_blackbird_tpu_torch.utils import logger as logmod  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import (  # noqa: E402
    membudget, simulate, timetrace)

OUTPUTS = ("contigs.fasta", "before_rr.fasta", "scaffolds.fasta",
           "assembly_graph_with_scaffolds.gfa", "assembly_graph.fastg")
CPU = ["--device", "cpu"]


def _simulate(path, size, seed, paired=False):
    genome = simulate.random_genome(size, seed=seed, repeats=[(300, 2)])
    r1, _, r2, _ = simulate.simulate_paired_reads(
        genome, int(30 * size / 120), read_len=60, insert_mean=200,
        insert_sd=15, error_rate=0.003, seed=seed + 1)
    if paired:
        for mate, reads in (("1", r1), ("2", r2)):
            fastq.write_reads_fastq(f"{path}_{mate}.fq",
                                    *dna.encode_reads(reads))
        return f"{path}_1.fq", f"{path}_2.fq"
    fastq.write_reads_fastq(f"{path}.fq", *dna.encode_reads(r1 + r2))
    return f"{path}.fq"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One single-end FASTQ file through both command lines at k = 21, 33:
    (reads, the port's output directory, the JAX package's)."""
    root = tmp_path_factory.mktemp("cli")
    reads = _simulate(str(root / "reads"), 6000, seed=11)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
        argv = ["-s", reads, "-k", "21,33", "--only-assembler"]
        assert cli.main(argv + ["-o", str(root / "port")] + CPU) == 0
        try:
            assert jcli.main(argv + ["-o", str(root / "jax")]) == 0
        finally:
            # the JAX command line leaves a writer on its closed log file
            jlogger.configure()
    return reads, root / "port", root / "jax"


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A smaller single-end file for the runs that need no reference."""
    root = tmp_path_factory.mktemp("small")
    return _simulate(str(root / "reads"), 2000, seed=5)


@pytest.fixture(autouse=True)
def _reference_logger_reset(monkeypatch):
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    yield
    jlogger.configure()


@pytest.fixture
def logger_untouched():
    """After ``main`` returns, by any path, the port's logger is what it
    was, and no writer of it holds a closed file."""
    before = logmod._config
    yield
    assert logmod._config is before
    logmod.get_logger("pipeline").info("still writable after the run")
    assert not timetrace.enabled()
    assert membudget.get_budget_gb() is None


def _fasta(path):
    return fastq.read_sequences(str(path))[1]


def test_outputs_match_the_reference(runs):
    _, port, jax_out = runs
    for name in OUTPUTS:
        assert (port / name).read_bytes() == (jax_out / name).read_bytes(), \
            name
    assert _fasta(port / "contigs.fasta")
    ours, theirs = (json.loads((d / "params.json").read_text())
                    for d in (port, jax_out))
    assert ours == theirs
    assert ours["stages"] == ["read_conversion", "k21", "k33",
                              "repeat_resolution", "contig_output"]
    lines = (port / "assembly_graph_with_scaffolds.gfa").read_text() \
        .splitlines()
    assert any(ln.startswith("S\t") for ln in lines)
    segments, links = gfa.read_gfa(
        str(port / "assembly_graph_with_scaffolds.gfa"))
    assert len(segments) == sum(ln.startswith("S\t") for ln in lines)
    for name in ("spades.log", "saves/checkpoint.dat",
                 "saves/contig_output/pack.npz",
                 "saves/repeat_resolution/pack.json"):
        assert (port / name).exists(), name
    # --checkpoints last keeps the last two stages' saves
    assert sorted(os.listdir(port / "saves")) == sorted(
        os.listdir(jax_out / "saves"))
    assert not os.listdir(port / "saves" / "phases")


def test_checkpoints_load_in_either_package(runs, tmp_path):
    _, port, jax_out = runs
    ours = stages.PipelineContext.load(str(jax_out / "saves/contig_output"),
                                       "cpu")
    theirs = jstages.PipelineContext.load(str(port / "saves/contig_output"))
    mine = stages.PipelineContext.load(str(port / "saves/contig_output"),
                                       "cpu")
    with np.load(port / "saves/contig_output/pack.npz") as a, \
            np.load(jax_out / "saves/contig_output/pack.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            assert a[name].shape == b[name].shape, name
            if a[name].dtype.kind != "f":
                assert np.array_equal(a[name], b[name]), name
    for ctx in (ours, theirs):
        assert ctx.contigs == mine.contigs
        assert ctx.final_contigs == mine.final_contigs
        assert ctx.read_length == mine.read_length == 60
        assert ctx.params == mine.params == {"ks_done": [21, 33]}
        assert vars(ctx.genomic_info) == vars(mine.genomic_info)
        assert ctx.graph.k == 33
        assert np.array_equal(np.asarray(ctx.codes), mine.codes.numpy())
    assert torch.equal(ours.graph.seq_flat, mine.graph.seq_flat)
    assert ours.graph.conj.dtype == torch.int64
    # each command line finishes a run the other began
    for src, main, extra in ((jax_out, cli.main, CPU), (port, jcli.main, [])):
        out = tmp_path / f"from_{src.name}"
        shutil.copytree(src, out)
        for name in OUTPUTS:
            os.remove(out / name)
        assert main(["-s", runs[0], "-k", "21,33", "--only-assembler",
                     "-o", str(out), "--restart-from", "contig_output"]
                    + extra) == 0
        for name in OUTPUTS:
            assert (out / name).read_bytes() == (port / name).read_bytes()


def test_stop_after_then_continue(runs, tmp_path, logger_untouched):
    reads, port, _ = runs
    out = tmp_path / "out"
    argv = ["-s", reads, "-k", "21,33", "--only-assembler", "-o", str(out)] \
        + CPU
    assert cli.main(argv + ["--stop-after", "k21"]) == 0
    assert (out / "saves/checkpoint.dat").read_text() == "k21"
    assert not (out / "contigs.fasta").exists()
    assert cli.main(argv + ["--continue"]) == 0
    for name in OUTPUTS:
        assert (out / name).read_bytes() == (port / name).read_bytes(), name
    log = (out / "spades.log").read_text()
    assert "resuming from saves of stage 'k21'" in log
    assert log.count("== STAGE k21\n") == 1
    # everything is done: another --continue runs no stage
    assert cli.main(argv + ["--continue"]) == 0
    log = (out / "spades.log").read_text()
    assert "all stages already complete (contig_output)" in log
    assert log.count("== STAGE k33\n") == 1


def test_restart_from(small, tmp_path, logger_untouched):
    out = tmp_path / "out"
    argv = ["-s", small, "-k", "21,33", "--only-assembler", "-o", str(out),
            "--checkpoints", "all", "--trace-time", "--memory", "64"] + CPU
    assert cli.main(argv) == 0
    assert sorted(os.listdir(out / "saves")) == sorted(
        ["checkpoint.dat", "phases", "read_conversion", "k21", "k33",
         "repeat_resolution", "contig_output"])
    trace = json.loads((out / "spades_time_trace.json").read_text())
    events = trace["traceEvents"]
    names = {ev["name"] for ev in events}
    assert {"stage:read_conversion", "stage:k21", "stage:k33",
            "stage:contig_output", "checkpoint_save", "count_kmers",
            "count_extra_contigs", "simplify", "read_parse", "read_upload",
            "checkpoint_fetch", "checkpoint_compress", "coverage_spectrum",
            "coverage_em", "simplify_cycle"} <= names
    # every span has an id, and every parent names a span of the dump
    # that holds it
    by_id = {ev["id"]: ev for ev in events}
    assert len(by_id) == len(events)
    for ev in events:
        assert {"name", "ph", "ts", "dur"} <= ev.keys()
        if ev["parent"] is not None:
            up = by_id[ev["parent"]]
            assert up["ts"] <= ev["ts"] + 1
            assert ev["ts"] + ev["dur"] <= up["ts"] + up["dur"] + 1
    parent_of = {ev["name"]: by_id[ev["parent"]]["name"] for ev in events
                 if ev["parent"] is not None}
    assert parent_of["read_parse"] == "stage:read_conversion"
    assert parent_of["coverage_em"] == "coverage_model_fit"
    assert parent_of["checkpoint_compress"] == "phase_checkpoint"
    parse = next(ev for ev in events if ev["name"] == "read_parse")
    assert parse["args"]["counts"]["reads"] > 0
    assert parse["args"]["counts"]["file_bytes"] == os.path.getsize(small)
    em = [ev["args"]["counts"] for ev in events if ev["name"] == "coverage_em"]
    assert len(em) == 2 and all(c["fit_evaluations"] > 0 and sum(
        v for key, v in c.items() if key.startswith("fit_path.")) == 1
        for c in em)
    first = {name: (out / name).read_bytes() for name in OUTPUTS}
    assert cli.main(argv + ["--restart-from", "k33"]) == 0
    assert first == {name: (out / name).read_bytes() for name in OUTPUTS}
    log = (out / "spades.log").read_text()
    assert log.count("== STAGE k21\n") == 1
    assert log.count("== STAGE k33\n") == 2
    # saves of the stage before are gone: roll back to the latest kept
    shutil.rmtree(out / "saves/k21")
    assert cli.main(argv + ["--restart-from", "k33"]) == 0
    log = (out / "spades.log").read_text()
    assert "saves for 'k21' missing; rolling back to 'read_conversion'" in log
    assert first == {name: (out / name).read_bytes() for name in OUTPUTS}
    assert cli.main(argv + ["--restart-from", "bogus"]) == 2


def test_checkpoints_none(small, tmp_path, logger_untouched):
    out = tmp_path / "out"
    assert cli.main(["-s", small, "-k", "21", "--only-assembler", "-o",
                     str(out), "--checkpoints", "none"] + CPU) == 0
    assert (out / "contigs.fasta").exists()
    assert not (out / "saves/checkpoint.dat").exists()
    assert os.listdir(out / "saves") == ["phases"]


def test_paired_input_runs_as_far_as_the_port_goes(tmp_path,
                                                   logger_untouched):
    p1, p2 = _simulate(str(tmp_path / "pe"), 2000, seed=7, paired=True)
    out = tmp_path / "out"
    argv = ["-1", p1, "-2", p2, "-k", "21,33", "--only-assembler", "-o",
            str(out)] + CPU
    # gap closing and paired repeat resolution are ported: the paired
    # run goes to the end and writes the paths and the library data
    assert cli.main(argv + ["--checkpoints", "none"]) == 0
    assert "gap_closing" in (out / "spades.log").read_text()
    for name in ("scaffolds.fasta", "contigs.paths", "scaffolds.paths",
                 "final.lib_data"):
        assert (out / name).exists(), name
    shutil.rmtree(out)
    assert cli.main(argv + ["--stop-after", "k33", "--pe-orientation",
                            "rf"]) == 0
    ctx = stages.PipelineContext.load(str(out / "saves/k33"), "cpu")
    n = ctx.codes.shape[0] // 2
    assert ctx.paired_ranges == [(0, n, n, n, "pe")]
    assert ctx.contigs and ctx.quals is not None
    # rf: both mates were reverse-complemented on the way in
    first = fastq.load_reads(p1).codes[0]
    assert dna.decode_codes(ctx.codes[0].numpy()) == dna.revcomp_str(
        dna.decode_codes(first))


@pytest.fixture(scope="module")
def mode_files(small, tmp_path_factory):
    """What the HMM and series requests name: a .hmm file of two domain
    profiles, and a series configuration over a two-sample profile of
    ``small``'s reads."""
    from spades_for_blackbird_tpu_torch.io import hmmfile
    from spades_for_blackbird_tpu_torch.mts import abundance
    from spades_for_blackbird_tpu_torch.ops import aa, hmm
    root = tmp_path_factory.mktemp("mode_files")
    hmm_path = str(root / "models.hmm")
    hmmfile.write_hmm_file(hmm_path, [
        hmm.hmm_from_consensus(f"d{i}", aa.encode_aa(m)) for i, m in
        enumerate(("MAGICHEMISTRYWKDNVFQ", "PLANTEDDQMAINKWYRSTV"))])
    b = fastq.load_reads(small)
    abundance.save_profiles(str(root / "prof.npz"), *abundance.
                            multiplicity_profiles(
                                [(b.codes, b.lengths),
                                 (b.codes[::2], b.lengths[::2])], 21,
                                device="cpu"), 21)
    yaml = root / "series.yaml"
    yaml.write_text(f"kmer_mult: {root}/prof.npz\n" + "".join(
        f"{key}: {root}/{key}.out\n"
        for key in ("edges_sqn", "edges_mpl", "edge_fragments_mpl")))
    return {"--custom-hmms": hmm_path, "--series-analysis": str(yaml)}


@pytest.mark.parametrize("extra,needle", [
    (["-1", "READS", "-2", "READS", "--meta", "--nanopore", "READS"],
     "hybrid_aligning"),
    (["--only-assembler", "--sanger", "READS"], "hybrid_aligning"),
    (["--only-assembler", "--bio", "--custom-hmms", "FILE"],
     "extract_domains"),
    (["--only-assembler", "--corona", "--custom-hmms", "FILE"],
     "domain_graph_construction"),
    (["--only-assembler", "--series-analysis", "FILE"], "series_analysis"),
    (["--only-assembler", "--nanopore", "READS"], "hybrid_aligning"),
    (["--only-assembler", "--pacbio", "READS"], "hybrid_aligning"),
    (["--plasmid", "--pacbio", "READS"], "hybrid_aligning_2"),
])
def test_unported_requests_exit_2_before_any_work(small, mode_files,
                                                  tmp_path, extra, needle,
                                                  logger_untouched):
    """The eight requests the port refused until its hybrid, HMM and
    series stages came (long reads, the HMM modes, the series analysis,
    alone and with the meta and plasmid modes) now run to the end, each
    through the stage it lacked (``FILE`` is what the flag before it
    names: an HMM set or a series configuration)."""
    out = tmp_path / "out"
    extra = [small if x == "READS" else
             mode_files[extra[i - 1]] if x == "FILE" else x
             for i, x in enumerate(extra)]
    assert cli.main(["-s", small, "-o", str(out), "--checkpoints", "none"]
                    + extra + CPU) == 0
    log = (out / "spades.log").read_text()
    assert f"== STAGE {needle} done" in log
    assert (out / "contigs.fasta").exists()


def test_mode_wrappers_and_mode_table(small, tmp_path, logger_untouched):
    out = str(tmp_path / "out")
    assert cli.main_meta(["-s", small, "-o", out, "--rna"] + CPU) == 2
    assert cli.main(["-s", small, "-o", out, "--bio"] + CPU) == 2
    # the meta and plasmid wrappers run their modes to the end
    run = ["-s", small, "-k", "21", "--only-assembler", "--checkpoints",
           "none"] + CPU
    assert cli.main_meta(run + ["-o", str(tmp_path / "meta")]) == 0
    assert "mode: meta" in (tmp_path / "meta" / "spades.log").read_text()
    assert cli.main_plasmid(run + ["-o", str(tmp_path / "plasmid")]) == 0
    assert (tmp_path / "plasmid" / "contigs.circular.fasta").exists()
    # every overlay builds
    for mode in MODES:
        assert config_for_mode(mode).mode == mode
    with pytest.raises(ValueError):
        config_for_mode("nonsense")
    assert config_for_mode("isolate", careful=True).careful


@pytest.mark.parametrize("argv", [
    ["-o", "OUT"],                                  # no input
    ["-1", "READS", "-o", "OUT"],                   # mismatched -1/-2
    ["--mp-1", "READS", "-o", "OUT"],
    ["-s", "READS", "-o", "OUT", "-k", "22"],       # even k
    ["-s", "READS", "-o", "OUT", "-k", "21,61"],    # k >= read length
    ["-s", "READS", "-o", "OUT", "-k", "9"],
    ["-s", "READS", "-o", "OUT", "-k", "x"],
    ["-s", "missing.fq", "-o", "OUT"],
    ["-s", "EMPTY", "-o", "OUT"],
    ["-s", "READS", "-o", "OUT", "--meta", "--rna"],
    ["-s", "READS", "-o", "OUT", "--custom-hmms", "missing.hmm"],
])
def test_usage_errors_exit_2(small, tmp_path, argv, logger_untouched):
    empty = tmp_path / "empty.fq"
    empty.write_text("")
    subst = {"READS": small, "OUT": str(tmp_path / "out"),
             "EMPTY": str(empty)}
    argv = [subst.get(a, a) for a in argv] + ["--only-assembler"] + CPU
    assert cli.main(argv) == 2
    assert not (tmp_path / "out" / "saves").exists()


def test_without_a_card_the_default_device_refuses(small, tmp_path, capsys,
                                                   logger_untouched):
    if torch.cuda.is_available():
        pytest.skip("shows the refusal on a machine without a card")
    out = tmp_path / "out"
    rc = cli.main(["-s", small, "-o", str(out), "--only-assembler"])
    assert rc not in (0, 2)
    assert "CUDA card" in capsys.readouterr().err
    assert not out.exists()  # nothing was read, nothing was written


def _stage_list(reads, out):
    args = cli.build_parser().parse_args(
        ["-s", reads, "-o", out, "--only-assembler"])
    return spades_stages.build_stage_list(args, [21, 33], print)


def _read_conversion(reads, out):
    return spades_stages.make_read_conversion([], [], [reads], print)


def _iteration(reads, out):
    ctx = stages.PipelineContext()
    batch = fastq.load_reads(reads)
    ctx.codes, ctx.lengths = batch.codes, batch.lengths
    spades_stages.make_iteration(21, print).fn(ctx)


def _manager(reads, out):
    return stages.StageManager(stages=[], output_dir=out)


def _load(reads, out):
    return stages.PipelineContext.load(
        os.path.join(out, "saves", "contig_output"))


@pytest.mark.parametrize("entry", [_stage_list, _read_conversion, _iteration,
                                   _manager, _load])
def test_without_a_card_no_stage_entry_point_takes_the_cpu(runs, entry):
    """Built without a device, the stage list and its parts run on the
    card, as every entry point of the port does: none of them falls to the
    CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("shows the refusal on a machine without a card")
    reads, port, _ = runs
    with pytest.raises(RuntimeError, match="CUDA card"):
        entry(reads, str(port))


def test_stage_list_on_request_runs_on_the_cpu(small, tmp_path):
    out = tmp_path / "out"
    args = cli.build_parser().parse_args(
        ["-s", small, "-o", str(out), "--only-assembler"])
    lines = []
    mgr = stages.StageManager(
        stages=spades_stages.build_stage_list(args, [21], lines.append,
                                              device="cpu"),
        output_dir=str(out), log=lines.append, device="cpu")
    ctx = mgr.run(stages.PipelineContext())
    assert ctx.codes.device.type == "cpu" and ctx.contigs
    assert mgr.device == torch.device("cpu")
    assert _fasta(out / "contigs.fasta") == [s for s, _ in ctx.contigs]


def test_parser_follows_the_reference():
    ours = {a.dest for a in cli.build_parser()._actions}
    theirs = {a.dest for a in jcli.build_parser()._actions}
    assert theirs - ours == {"supervise", "supervise_stall_s"}
    assert ours - theirs == {"device"}
