"""The PyTorch port's command line on paired reads vs the JAX package's:
``-1/-2`` through both, a run stopped after gap closing in one package
and finished in the other, and the other paired inputs (``--12``,
``--mp-1/--mp-2``)."""

import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from spades_for_blackbird_tpu import cli as jcli  # noqa: E402
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import cli  # noqa: E402
from spades_for_blackbird_tpu_torch.io import gfa  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

# every file a paired run writes, besides spades.log and params.json
OUTPUTS = ("contigs.fasta", "scaffolds.fasta", "before_rr.fasta",
           "assembly_graph_with_scaffolds.gfa", "assembly_graph.fastg",
           "contigs.paths", "scaffolds.paths", "final.lib_data",
           "scaffold_graph.scg", "scaffold_graph.dot")
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _reference_logger_reset(monkeypatch):
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    jlogger.configure()
    yield
    # the JAX command line leaves a writer on its closed log file
    jlogger.configure()


def _simulate(root, size, seed, insert=300):
    genome = simulate.random_genome(size, seed=seed, repeats=[(400, 2)])
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, int(30 * size / 200), read_len=100, insert_mean=insert,
        insert_sd=insert / 12, error_rate=0.002, seed=seed + 1)
    paths = (str(root / f"r{seed}_1.fq"), str(root / f"r{seed}_2.fq"))
    simulate.write_fastq(paths[0], r1, q1)
    simulate.write_fastq(paths[1], r2, q2)
    return paths, (r1, q1, r2, q2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One 6 kb paired library (100 bp, insert 300) through both command
    lines at k = 21, 33 without correction: (argv, port's output, JAX's)."""
    root = tmp_path_factory.mktemp("cli_paired")
    jlogger.configure()  # an earlier test may leave a closed file on it
    (p1, p2), _ = _simulate(root, 6000, seed=61)
    argv = ["-1", p1, "-2", p2, "-k", "21,33", "--only-assembler"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
        assert cli.main(argv + ["-o", str(root / "port")] + CPU) == 0
        try:
            assert jcli.main(argv + ["-o", str(root / "jax")]) == 0
        finally:
            jlogger.configure()
    return argv, root / "port", root / "jax"


def test_paired_outputs_match_the_reference(runs):
    _, port, jax_out = runs
    for name in OUTPUTS:
        assert (port / name).read_bytes() == (jax_out / name).read_bytes(), \
            name
    log = (port / "spades.log").read_text()
    for stage in ("gap_closing", "repeat_resolution"):
        assert f"== STAGE {stage}" in log
    # the scaffolds ride the GFA as P-lines
    _, _, paths = gfa.read_gfa(
        str(port / "assembly_graph_with_scaffolds.gfa"), with_paths=True)
    assert paths
    assert "pairs_used" in (port / "final.lib_data").read_text()


@pytest.mark.parametrize("first,then", [("port", "jax"), ("jax", "port")])
def test_stop_after_gap_closing_then_continue_in_the_other(runs, tmp_path,
                                                           first, then):
    argv, port, _ = runs
    mains = {"port": lambda a: cli.main(a + CPU), "jax": jcli.main}
    out = ["-o", str(tmp_path / "out")]
    try:
        assert mains[first](argv + out + ["--stop-after",
                                          "gap_closing"]) == 0
        assert not (tmp_path / "out" / "contigs.fasta").exists()
        assert mains[then](argv + out + ["--continue"]) == 0
    finally:
        jlogger.configure()
    for name in OUTPUTS:
        assert (tmp_path / "out" / name).read_bytes() == \
            (port / name).read_bytes(), name


def test_interlaced_and_mate_pair_inputs_run(tmp_path):
    """``--12`` (mates alternate in one file) and ``--mp-1/--mp-2`` (an
    RF mate-pair library, here beside a paired-end one) run to the end."""
    (p1, p2), (r1, q1, r2, q2) = _simulate(tmp_path, 4000, seed=71)
    inter = str(tmp_path / "inter.fq")
    simulate.write_fastq(inter, [r for pair in zip(r1, r2) for r in pair],
                         [q for pair in zip(q1, q2) for q in pair])
    common = ["-k", "21", "--only-assembler", "--checkpoints", "none"]
    out = tmp_path / "inter"
    assert cli.main(["--12", inter, "-o", str(out)] + common + CPU) == 0
    assert "interlaced" in (out / "spades.log").read_text()
    assert (out / "scaffolds.paths").exists()
    (m1, m2), _ = _simulate(tmp_path, 4000, seed=81, insert=1500)
    out = tmp_path / "mp"
    assert cli.main(["-1", p1, "-2", p2, "--mp-1", m1, "--mp-2", m2,
                     "--mp-orientation", "fr", "-o", str(out)]
                    + common + CPU) == 0
    lib_data = (out / "final.lib_data").read_text()
    assert "kind: pe" in lib_data and "kind: mp" in lib_data
    assert os.path.getsize(out / "scaffolds.fasta") > 0
