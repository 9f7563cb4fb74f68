"""GFA graph input (``--assembly-graph``, the fork's LoadGraph) in the
PyTorch port vs the JAX package: a GFA written by either command line
loads to the same graph, both command lines give the same outputs from
it, single-end and paired, and a run begun by one finishes under the
other."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from spades_for_blackbird_tpu import cli as jcli  # noqa: E402
from spades_for_blackbird_tpu.graph import from_gfa as jfrom_gfa  # noqa: E402
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import cli, interop  # noqa: E402
from spades_for_blackbird_tpu_torch.graph import from_gfa  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

CPU = ["--device", "cpu"]
OUTPUTS = ("contigs.fasta", "scaffolds.fasta", "before_rr.fasta",
           "assembly_graph_with_scaffolds.gfa", "assembly_graph.fastg")
PAIRED_OUTPUTS = OUTPUTS + ("contigs.paths", "scaffolds.paths",
                            "final.lib_data")


@pytest.fixture(autouse=True)
def _reference_logger_reset(monkeypatch):
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    jlogger.configure()
    yield
    # the JAX command line leaves a writer on its closed log file
    jlogger.configure()


def _jax_main(argv):
    try:
        return jcli.main(argv)
    finally:
        jlogger.configure()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A 5 kb paired library and the GFA each command line assembles from
    it at k = 33 (single-end, no correction): (mates, {package: GFA})."""
    root = tmp_path_factory.mktemp("gfa_input")
    genome = simulate.random_genome(5000, seed=81, repeats=[(300, 2)])
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, 750, read_len=100, insert_mean=300, insert_sd=25,
        error_rate=0.002, seed=82)
    mates = (str(root / "r_1.fq"), str(root / "r_2.fq"))
    simulate.write_fastq(mates[0], r1, q1)
    simulate.write_fastq(mates[1], r2, q2)
    argv = ["-s", mates[0], "-s", mates[1], "-k", "33", "--only-assembler",
            "--checkpoints", "none"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
        assert cli.main(argv + ["-o", str(root / "port")] + CPU) == 0
        assert _jax_main(argv + ["-o", str(root / "jax")]) == 0
    gfas = {name: str(root / name / "assembly_graph_with_scaffolds.gfa")
            for name in ("port", "jax")}
    return mates, gfas


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gfa_loads_to_the_same_graph(inputs, writer):
    path = inputs[1][writer]
    g, names = from_gfa.graph_from_gfa(path, return_names=True,
                                       device="cpu")
    jg, jnames = jfrom_gfa.graph_from_gfa(path, return_names=True)
    assert names == jnames and g.k == jg.k
    a = interop.graph_to_numpy(g)
    b = interop.fields_of(jg, interop.GRAPH_FIELDS)
    for name in ("seq_flat", "seq_start", "seq_len", "start_v", "end_v",
                 "conj", "alive", "num_edges", "cov"):
        assert np.array_equal(a[name], b[name]), name
    assert a["flank"] is None and b["flank"] is None


@pytest.mark.parametrize("paired", [False, True])
def test_assembly_graph_command_line_matches_jax(inputs, tmp_path, paired):
    (m1, m2), gfas = inputs
    reads = ["-1", m1, "-2", m2] if paired else ["-s", m1]
    argv = reads + ["--only-assembler", "--assembly-graph", gfas["jax"],
                    "--checkpoints", "none"]
    assert cli.main(argv + ["-o", str(tmp_path / "port")] + CPU) == 0
    assert _jax_main(argv + ["-o", str(tmp_path / "jax")]) == 0
    for name in PAIRED_OUTPUTS if paired else OUTPUTS:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    log = (tmp_path / "port" / "spades.log").read_text()
    assert "== STAGE load_graph" in log and "== STAGE k" not in log


@pytest.mark.parametrize("first,then", [("port", "jax"), ("jax", "port")])
def test_continue_across_packages(inputs, tmp_path, first, then):
    (m1, m2), gfas = inputs
    argv = ["-1", m1, "-2", m2, "--only-assembler", "--assembly-graph",
            gfas["port"], "-o", str(tmp_path / "out")]
    run = {"port": lambda a: cli.main(a + CPU), "jax": _jax_main}
    assert run[first](argv + ["--stop-after", "load_graph"]) == 0
    assert not (tmp_path / "out" / "contigs.fasta").exists()
    assert run[then](argv + ["--continue"]) == 0
    log = (tmp_path / "out" / "spades.log").read_text()
    assert log.count("== STAGE load_graph\n") == 1
    assert "== STAGE gap_closing" in log
    assert run[first](argv + ["-o", str(tmp_path / "whole"),
                              "--checkpoints", "none"]) == 0
    for name in PAIRED_OUTPUTS:
        assert (tmp_path / "out" / name).read_bytes() == \
            (tmp_path / "whole" / name).read_bytes(), name
