"""The PyTorch port's metagenomic mode vs the JAX package's: the
relative-coverage edge disconnector (red), the meta simplification cycle,
``-1/-2 --meta`` through both command lines (two-step repeat resolution),
a resume across the packages at ``second_phase_setup``, and what the
second phase is handed.

Every pass is handed the same graph (built by the JAX package, carried
over with ``interop``). Integer results must be bit-equal; coverage
after a pass is held at rtol 1e-5, since recondense sums float32
coverage in another order than XLA. The command lines' output files
must be byte-identical.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import naive_debruijn as nd  # noqa: E402
from spades_for_blackbird_tpu import cli as jcli  # noqa: E402
from spades_for_blackbird_tpu.graph import condense as jcondense  # noqa: E402
from spades_for_blackbird_tpu.graph import graph as jgraph  # noqa: E402
from spades_for_blackbird_tpu.kmers import counter as jcounter  # noqa: E402
from spades_for_blackbird_tpu.kmers import extension as jext  # noqa: E402
from spades_for_blackbird_tpu.pipeline import assemble as jassemble  # noqa: E402
from spades_for_blackbird_tpu.pipeline import config as jconfig  # noqa: E402
from spades_for_blackbird_tpu.pipeline import spades_stages as jstages  # noqa: E402
from spades_for_blackbird_tpu.pipeline import stages as jpstages  # noqa: E402
from spades_for_blackbird_tpu.simplify import advanced as jadv  # noqa: E402
from spades_for_blackbird_tpu.simplify import runner as jrunner  # noqa: E402
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import cli, interop  # noqa: E402
from spades_for_blackbird_tpu_torch.graph.graph import edge_mask  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import assemble  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import config  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import spades_stages  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import stages  # noqa: E402
from spades_for_blackbird_tpu_torch.simplify import advanced  # noqa: E402
from spades_for_blackbird_tpu_torch.simplify import runner  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

K = 15
COV_RTOL = 1e-5  # float32 sums in another order than XLA's
CPU = ["--device", "cpu"]
# what the meta command line writes (every file but the log)
META_OUTPUTS = ("contigs.fasta", "scaffolds.fasta", "before_rr.fasta",
                "assembly_graph_with_scaffolds.gfa", "assembly_graph.fastg",
                "contigs.paths", "scaffolds.paths", "final.lib_data",
                "scaffold_graph.scg", "scaffold_graph.dot", "params.json")


@pytest.fixture(autouse=True)
def _reference_logger_reset(monkeypatch):
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    jlogger.configure()
    yield
    # the JAX command line leaves a writer on its closed log file
    jlogger.configure()


def random_dna(n, seed):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), size=n))


def cover(genome, read_len=50, step=5, times=1):
    return [genome[i:i + read_len]
            for i in range(0, len(genome) - read_len + 1, step)] * times


def compact_graph(reads, k=K):
    """tests/test_advanced_simplification.py::build_graph."""
    codes, lengths = dna.encode_reads(reads)
    kp1 = jcounter.count_kmers(codes, lengths, k + 1)
    vt = jext.build_vertex_table(kp1, k)
    return jgraph.compact_graph(jcondense.build_graph(kp1, vt, k))


def port_graph(jg):
    return interop.graph_from_numpy(
        interop.fields_of(jg, interop.GRAPH_FIELDS), jg.k)


def assert_graphs_equal(g, jg):
    a = interop.graph_to_numpy(g)
    b = interop.fields_of(jg, interop.GRAPH_FIELDS)
    assert g.capacity == jg.capacity and g.k == jg.k
    for name in ("seq_flat", "seq_start", "seq_len", "start_v", "end_v",
                 "conj", "alive", "num_edges"):
        assert np.array_equal(a[name], b[name]), name
    for name in ("cov", "flank"):
        if b[name] is None:
            assert a[name] is None
        else:
            np.testing.assert_allclose(a[name], b[name], rtol=COV_RTOL,
                                       atol=0.0, err_msg=name)


def red_fixture_graph():
    """tests/test_advanced_simplification.py:98: a low-coverage chimera
    between two far points of a 20x genome."""
    g1 = random_dna(500, 30)
    reads = cover(g1, times=20) + [g1[100:130] + g1[300:330]]
    return compact_graph(reads)


def red_branches_graph():
    """A 60x genome with two chimeras: one read (far below 1/50 of its
    neighbours: the unconditional branch) and four reads (between 1/50
    and 1/10: only the edge_sum branch, whose high-coverage neighbourhood
    must be long enough)."""
    g1 = random_dna(900, 31)
    reads = cover(g1, times=60)
    reads.append(g1[100:130] + g1[500:530])
    reads += [g1[250:280] + g1[700:730]] * 4
    return compact_graph(reads)


RED_CASES = {
    # name: (fixture, keyword arguments of disconnect_relative_low)
    "jax_fixture": (red_fixture_graph, dict(diff_mult=10.0, edge_sum=50)),
    "unconditional_only": (red_branches_graph, dict(
        diff_mult=1e9, edge_sum=0, unconditional_diff_mult=50.0)),
    "edge_sum_only": (red_branches_graph, dict(diff_mult=10.0,
                                               edge_sum=300)),
    "edge_sum_too_long": (red_branches_graph, dict(diff_mult=10.0,
                                                   edge_sum=100_000)),
    "meta_settings": (red_branches_graph, dict(
        diff_mult=10.0, edge_sum=10000, unconditional_diff_mult=50.0)),
}


@pytest.mark.parametrize("name", list(RED_CASES))
def test_disconnect_relative_low_matches_jax(name):
    fixture, kw = RED_CASES[name]
    jg, v_space = fixture()
    out, vs, n = advanced.disconnect_relative_low(port_graph(jg), v_space,
                                                  **kw)
    jout, jvs, jn = jadv.disconnect_relative_low(jg, v_space, **kw)
    assert (vs, n) == (jvs, jn)
    assert_graphs_equal(out, jout)
    # each branch is reached on its own; a neighbourhood shorter than
    # edge_sum blocks the conditional one
    if name == "edge_sum_too_long":
        assert n == 0
    else:
        assert n >= 1


def _meta_graph():
    """Two genomes at 8x and 60x, a strain copy of the rich one with a
    few substitutions at 3x, and chimeric reads: what red, the rcc block
    and the meta hidden-EC remover exist for."""
    a = simulate.random_genome(3000, seed=41, repeats=[(200, 2)])
    b = simulate.random_genome(2000, seed=42)
    strain = list(b[500:1500])
    for p in range(50, len(strain), 200):
        strain[p] = "ACGT"[("ACGT".index(strain[p]) + 1) % 4]
    strain = "".join(strain)
    rng = np.random.default_rng(43)
    reads = []
    for genome, cov in ((a, 8), (b, 60), (strain, 3)):
        for _ in range(cov * len(genome) // 60):
            p = int(rng.integers(0, len(genome) - 60))
            reads.append(genome[p:p + 60])
    reads += [a[500:530] + nd.rc(b[1500:1530]), b[300:330] + b[1700:1730]]
    codes, lengths = dna.encode_reads(reads)
    kp1 = jcounter.trim_table(jcounter.count_kmers(
        jnp.asarray(codes), jnp.asarray(lengths), 22))
    vt = jext.trim_vertex_table(jext.build_vertex_table(kp1, 21))
    return jgraph.compact_graph(jcondense.build_graph(kp1, vt, 21))


def test_meta_simplification_cycle_matches_jax():
    jg, v_space = _meta_graph()
    cfg = config.config_for_mode("meta").simplify
    jcfg = jconfig.config_for_mode("meta").simplify
    cfg, jcfg = (dataclasses.replace(c, read_length=60) for c in (cfg, jcfg))
    assert cfg.red_enabled and cfg.her_meta and cfg.rcc_enabled
    out = runner.simplify_graph(port_graph(jg), v_space, 4.0, cfg)
    jout = jrunner.simplify_graph(jg, v_space, 4.0, jcfg)
    assert_graphs_equal(out, jout)
    assert int(edge_mask(out).sum()) < int(np.asarray(
        jgraph.edge_mask(jg)).sum())


def test_every_mode_config_matches_jax():
    """Every overlay builds in the port with the JAX package's values,
    every field of SimplifyConfig (the max-flow EC remover's mfec_*
    fields among them) included."""
    port_fields = [f.name for f in dataclasses.fields(runner.SimplifyConfig)]
    assert port_fields == [f.name for f in
                           dataclasses.fields(jrunner.SimplifyConfig)]
    for mode in config.MODES:
        cfg, jcfg = config.config_for_mode(mode), \
            jconfig.config_for_mode(mode)
        for f in dataclasses.fields(cfg):
            if f.name not in ("simplify", "pe"):
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), \
                    (mode, f.name)
        for f in dataclasses.fields(jcfg.simplify):
            assert getattr(cfg.simplify, f.name) == getattr(
                jcfg.simplify, f.name), (mode, f.name)
    assert not hasattr(runner, "_UNPORTED")


def _community(root):
    """FR pairs (100 bp, insert 300) of a 9 kb genome at 40x and a 5 kb
    one at 12x, with qualities."""
    r1, q1, r2, q2 = [], [], [], []
    for size, seed, pairs in ((9000, 51, 1800), (5000, 52, 300)):
        genome = simulate.random_genome(size, seed=seed, repeats=[(300, 2)])
        got = simulate.simulate_paired_reads(
            genome, pairs, read_len=100, insert_mean=300, insert_sd=25,
            error_rate=0.002, seed=seed + 10)
        for acc, part in zip((r1, q1, r2, q2), got):
            acc += part
    paths = [os.path.join(root, f"meta_{m}.fq") for m in (1, 2)]
    simulate.write_fastq(paths[0], r1, q1)
    simulate.write_fastq(paths[1], r2, q2)
    return paths


@pytest.fixture(scope="module")
def meta_runs(tmp_path_factory):
    """``-1/-2 --meta -k 21 --only-assembler --checkpoints all`` through
    both command lines: (argv, the port's output, the JAX package's)."""
    root = tmp_path_factory.mktemp("meta")
    p1, p2 = _community(str(root))
    argv = ["-1", p1, "-2", p2, "--meta", "-k", "21", "--only-assembler",
            "--checkpoints", "all"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
        assert cli.main(argv + ["-o", str(root / "port")] + CPU) == 0
        try:
            assert jcli.main(argv + ["-o", str(root / "jax")]) == 0
        finally:
            jlogger.configure()
    return argv, root / "port", root / "jax"


def test_meta_command_line_matches_jax(meta_runs):
    _, port, jax_out = meta_runs
    for name in META_OUTPUTS:
        assert (port / name).read_bytes() == (jax_out / name).read_bytes(), \
            name
    log = (port / "spades.log").read_text()
    assert "mode: meta" in log and "second phase:" in log
    for stage in ("second_phase_setup", "repeat_resolution_2"):
        assert f"== STAGE {stage}\n" in log
        assert (port / "saves" / stage / "pack.npz").exists()


def test_meta_resumes_across_packages(meta_runs, tmp_path):
    """The JAX command line finishes a meta run the port stopped after
    its first repeat resolution (the other way round is the same saves
    read by the other package, tests/test_torch_cli.py)."""
    argv, port, _ = meta_runs
    out = tmp_path / "out"
    shutil.copytree(port, out)
    for name in META_OUTPUTS:
        os.remove(out / name)
    for stage in ("second_phase_setup", "repeat_resolution_2",
                  "contig_output"):
        shutil.rmtree(out / "saves" / stage)
    (out / "saves" / "checkpoint.dat").write_text("repeat_resolution")
    try:
        assert jcli.main(argv + ["-o", str(out), "--continue"]) == 0
    finally:
        jlogger.configure()
    for name in META_OUTPUTS:
        assert (out / name).read_bytes() == (port / name).read_bytes(), name
    log = (out / "spades.log").read_text()
    assert "resuming from saves of stage 'repeat_resolution'" in log


def test_second_phase_takes_the_isolate_config(monkeypatch):
    """Pins a reference-side behaviour: the JAX package's second phase
    calls ``assemble_single_k`` at the last K with the preliminary RR
    contigs, the restricted sequences, and neither the mode's
    SimplifyConfig nor its min_kmer_count; the port hands it the same."""
    calls = {}

    def recorder(name):
        def fake(codes, lengths, k, **kw):
            calls[name] = (k, kw)
            return jassemble.AssemblyResult(contigs=[("ACGT", 1.0)],
                                            genomic_info=None, stats={},
                                            graph="graph")
        return fake

    monkeypatch.setattr(jassemble, "assemble_single_k", recorder("jax"))
    monkeypatch.setattr(assemble, "assemble_single_k", recorder("port"))
    args = cli.build_parser().parse_args(["-s", "r.fq", "-o", "out",
                                          "--meta"])
    cfg, jcfg = config.config_for_mode("meta"), jconfig.config_for_mode("meta")
    found = []
    for build, ctx in (
            (lambda: spades_stages.build_stage_list(args, [21, 33], print,
                                                    cfg, device="cpu"),
             stages.PipelineContext()),
            (lambda: jstages.build_stage_list(args, [21, 33], print, jcfg),
             jpstages.PipelineContext())):
        stage = next(s for s in build() if s.name == "second_phase_setup")
        ctx.graph = "preliminary graph"
        ctx.codes = ctx.lengths = None
        ctx.final_contigs = [("ACGTACGT", 2.0), ("TTTT", 1.0)]
        ctx.params["restricted_seqs"] = ["ACG"]
        stage.fn(ctx)
        found.append((ctx.graph, ctx.contigs))
    assert found[0] == found[1] == ("graph", [("ACGT", 1.0)])
    (k, kw), (jk, jkw) = calls["port"], calls["jax"]
    assert k == jk == 33
    assert jkw == {"extra_sequences": ["ACGTACGT", "TTTT"],
                   "restricted_sequences": ["ACG"]}
    assert kw == dict(jkw, device=torch.device("cpu"))
    assert cfg.simplify.rounds == 3 and cfg.simplify.red_enabled
