"""The command line with error correction, the port's against the JAX
package's: the default command (BayesHammer, then the ladder) on a FASTQ
file with qualities, ``--only-error-correction``, ``--iontorrent``, and
each command line finishing a run the other stopped after the
correction."""

import gzip
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from spades_for_blackbird_tpu import cli as jcli  # noqa: E402
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import cli  # noqa: E402
from spades_for_blackbird_tpu_torch.io import fastq  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import (  # noqa: E402
    spades_stages, stages)
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

OUTPUTS = ("contigs.fasta", "before_rr.fasta", "scaffolds.fasta",
           "assembly_graph_with_scaffolds.gfa", "assembly_graph.fastg")
CPU = ["--device", "cpu"]
KS = ["-k", "21,33"]


@pytest.fixture(autouse=True)
def _reference_logger_reset(monkeypatch):
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    yield
    # the JAX command line leaves a writer on its closed log file
    jlogger.configure()


def port_main(argv):
    return cli.main(argv + CPU)


def jax_main(argv):
    try:
        return jcli.main(argv)
    finally:
        jlogger.configure()


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """6 kb of single-end 60 bp reads with their qualities."""
    root = tmp_path_factory.mktemp("reads")
    genome = simulate.random_genome(6000, seed=11, repeats=[(300, 2)])
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, 1500, read_len=60, insert_mean=200, insert_sd=15,
        error_rate=0.005, seed=12)
    path = str(root / "reads.fq")
    simulate.write_fastq(path, r1 + r2, q1 + q2)
    return path


@pytest.fixture(scope="module")
def default_runs(reads, tmp_path_factory):
    """The default command through both command lines:
    {package: output directory}."""
    root = tmp_path_factory.mktemp("default")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
        argv = ["-s", reads] + KS
        assert port_main(argv + ["-o", str(root / "port")]) == 0
        assert jax_main(argv + ["-o", str(root / "jax")]) == 0
    return {"port": root / "port", "jax": root / "jax"}


def pack_params(out, stage):
    with open(os.path.join(out, "saves", stage, "pack.json")) as f:
        return json.load(f)["params"]


def corrected(out):
    with gzip.open(os.path.join(out, "corrected", "corrected.fastq.gz")) as f:
        return f.read()


def test_default_command_matches_the_reference(default_runs):
    port, theirs = default_runs["port"], default_runs["jax"]
    for name in OUTPUTS:
        assert (port / name).read_bytes() == (theirs / name).read_bytes(), \
            name
    ours = json.loads((port / "params.json").read_text())
    assert ours == json.loads((theirs / "params.json").read_text())
    assert ours["stages"] == ["read_conversion", "error_correction", "k21",
                              "k33", "repeat_resolution", "contig_output"]
    hammer = pack_params(port, "contig_output")["hammer"]
    assert hammer == pack_params(theirs, "contig_output")["hammer"]
    assert hammer["mode"] == "bayes" and hammer["changed_bases"] > 0
    log = (port / "spades.log").read_text()
    assert "correction: {" in log
    # the corrected reads are passed on, not written, without the flag
    assert not (port / "corrected").exists()


@pytest.mark.parametrize("first,second", [("port", "jax"), ("jax", "port")])
def test_each_command_line_finishes_a_run_the_other_corrected(
        reads, default_runs, tmp_path, first, second):
    mains = {"port": port_main, "jax": jax_main}
    out = str(tmp_path / "out")
    argv = ["-s", reads, "-o", out] + KS
    assert mains[first](argv + ["--stop-after", "error_correction"]) == 0
    with open(os.path.join(out, "saves", "checkpoint.dat")) as f:
        assert f.read() == "error_correction"
    assert not os.path.exists(os.path.join(out, "contigs.fasta"))
    params = pack_params(out, "error_correction")
    assert params["hammer"] == pack_params(default_runs["port"],
                                           "contig_output")["hammer"]
    ctx = stages.PipelineContext.load(
        os.path.join(out, "saves", "error_correction"), "cpu")
    assert ctx.quals is not None and ctx.codes.dtype == torch.uint8
    assert mains[second](argv + ["--continue"]) == 0
    for name in OUTPUTS:
        assert open(os.path.join(out, name), "rb").read() == \
            (default_runs["port"] / name).read_bytes(), name


def test_only_error_correction_matches_the_reference(reads, tmp_path):
    outs = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        outs[name] = str(tmp_path / name)
        assert main(["-s", reads, "-o", outs[name],
                     "--only-error-correction"]) == 0
        assert not os.path.exists(os.path.join(outs[name], "contigs.fasta"))
    assert corrected(outs["port"]) == corrected(outs["jax"])
    assert corrected(outs["port"]).count(b"\n@") == 2999
    assert json.load(open(os.path.join(outs["port"], "params.json"))) == \
        json.load(open(os.path.join(outs["jax"], "params.json")))


def test_iontorrent_matches_the_reference(reads, tmp_path):
    outs = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        outs[name] = tmp_path / name
        assert main(["-s", reads, "-o", str(outs[name]), "-k", "21",
                     "--iontorrent"]) == 0
    for name in OUTPUTS:
        assert (outs["port"] / name).read_bytes() == \
            (outs["jax"] / name).read_bytes(), name
    assert corrected(outs["port"]) == corrected(outs["jax"])
    ion = pack_params(outs["port"], "contig_output")["ionhammer"]
    assert ion == pack_params(outs["jax"], "contig_output")["ionhammer"]
    assert ion["changed_runs"] >= 0 and ion["solid_hkmers"] > 0


def test_correction_stage_without_a_card_refuses(reads, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("shows the refusal on a machine without a card")
    ctx = stages.PipelineContext()
    batch = fastq.load_reads(reads, with_quals=True)
    ctx.codes = torch.from_numpy(batch.codes)
    ctx.lengths = torch.from_numpy(batch.lengths)
    ctx.quals = batch.quals
    for stage in (spades_stages.make_error_correction(print),
                  spades_stages.make_ion_error_correction(print)):
        with pytest.raises(RuntimeError, match="CUDA card"):
            stage.fn(ctx)
    stage = spades_stages.make_error_correction(print, device="cpu")
    stage.fn(ctx)
    assert ctx.params["hammer"]["mode"] == "bayes"
    assert ctx.codes.device.type == "cpu"
    assert np.array_equal(ctx.lengths.numpy(), batch.lengths)
