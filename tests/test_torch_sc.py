"""The PyTorch port's single-cell (MDA) simplification vs the JAX
package's: each pass of the sc overlay on the JAX tests' own graphs, the
graph-based EC bound of uneven-depth runs, the ``sc`` mode table and the
``--sc`` command line.

Every pass is handed the same graph (built by the JAX package, carried
over with ``interop``). Integer results must be bit-equal; coverage
after a pass is held at rtol 1e-5, since recondense sums float32
coverage in another order than XLA.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import naive_debruijn as nd  # noqa: E402
from spades_for_blackbird_tpu import cli as jcli  # noqa: E402
from spades_for_blackbird_tpu.graph import condense as jcondense  # noqa: E402
from spades_for_blackbird_tpu.graph import construct as jconstruct  # noqa: E402
from spades_for_blackbird_tpu.graph import graph as jgraph  # noqa: E402
from spades_for_blackbird_tpu.kmers import counter as jcounter  # noqa: E402
from spades_for_blackbird_tpu.kmers import extension as jext  # noqa: E402
from spades_for_blackbird_tpu.pipeline import assemble as jassemble  # noqa: E402
from spades_for_blackbird_tpu.pipeline import config as jconfig  # noqa: E402
from spades_for_blackbird_tpu.simplify import advanced as jadv  # noqa: E402
from spades_for_blackbird_tpu.simplify import ec_threshold as ject  # noqa: E402
from spades_for_blackbird_tpu.simplify import passes as jpasses  # noqa: E402
from spades_for_blackbird_tpu.simplify import runner as jrunner  # noqa: E402
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import cli, interop  # noqa: E402
from spades_for_blackbird_tpu_torch.graph.graph import edge_mask  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import assemble  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import config  # noqa: E402
from spades_for_blackbird_tpu_torch.simplify import advanced  # noqa: E402
from spades_for_blackbird_tpu_torch.simplify import ec_threshold  # noqa: E402
from spades_for_blackbird_tpu_torch.simplify import passes  # noqa: E402
from spades_for_blackbird_tpu_torch.simplify import runner  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

K = 15
COV_RTOL = 1e-5  # float32 sums in another order than XLA's


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


def tile(s, L=50, step=5):
    return [s[i:i + L] for i in range(0, len(s) - L + 1, step)] + \
        [s[len(s) - L:]]


def compact_graph(reads):
    """tests/test_advanced_simplification.py::build_graph."""
    codes, lengths = dna.encode_reads(reads)
    kp1 = jcounter.count_kmers(codes, lengths, K + 1)
    vt = jext.build_vertex_table(kp1, K)
    return jgraph.compact_graph(jcondense.build_graph(kp1, vt, K))


# The JAX tests' fixtures: tests/test_advanced_simplification.py:77-98,
# 141-167, 230-300 and tests/test_rna_rcc_json.py:47-62.
def rcc_graph():
    g1, g2 = random_dna(300, 20), random_dna(300, 21)
    reads = cover(g1, times=10) + cover(g2, times=10)
    reads.append(g1[120:150] + g2[120:150])
    return compact_graph(reads)


def hidden_ec_graph():
    stem = random_dna(1600, 50)
    strong = stem + random_dna(200, 51)
    weak_branch = stem[-30:] + random_dna(60, 52)
    reads = cover(strong, read_len=100, step=4, times=5) + [weak_branch]
    return compact_graph(reads)


def hairpin_graph():
    """A unique stem whose end forks into a hairpin and its conjugate:
    the meta hidden-EC remover's suspicious vertex."""
    stem = random_dna(1600, 50)
    reads = cover(stem, read_len=100, step=4, times=5)
    reads.append(stem[-30:] + random_dna(20, 53) + nd.rc(stem[-30:]))
    return compact_graph(reads)


def trec_graph():
    A, B, C, D = (random_dna(250, s) for s in (60, 61, 62, 63))
    reads = cover(A + B, times=6) + cover(C + D, times=6)
    reads.append((A + B)[235:265] + (C + D)[330:360])
    return compact_graph(reads)


def thorn_graph():
    G = random_dna(900, 70)
    reads = cover(G, times=6) + [G[285:315] + nd.rc(G[600:630])]
    return compact_graph(reads)


def multiplicity_graph():
    core, R = random_dna(300, 80), random_dna(20, 81)
    L3, B = random_dna(400, 82), random_dna(300, 83)
    reads = cover(core + L3, times=6) + cover(core + R + B, times=6)
    reads.append((core + R)[-14 - 16:] + random_dna(20, 84)
                 + (core + L3)[500:530])
    return compact_graph(reads)


def rna_rcc_graph():
    a, b = random_dna(300, 2), random_dna(300, 3)
    reads = tile(a) * 6 + tile(b) * 6 + [a[130:160] + b[130:160]]
    codes, lengths = dna.encode_reads(reads)
    g = jconstruct.graph_from_reads(codes, lengths, K)
    return g, 4 * g.capacity


def _both(name, **kw):
    """(port pass, JAX pass) of advanced.<name> with these arguments."""
    return (lambda g, v: getattr(advanced, name)(g, v, **kw),
            lambda g, v: getattr(jadv, name)(g, v, **kw))


CASES = {
    # name: (fixture, port pass, JAX pass); a pass returns (g, v_space, n)
    "rcc_components": (rcc_graph, *_both(
        "remove_rcc_components", coverage_gap=5.0, length_bound=100,
        tip_allowing_length_bound=150,
        longest_connecting_path_bound=K + 30, vertex_count_limit=30)),
    "relative_low_coverage": (
        rna_rcc_graph,
        lambda g, v: (passes.remove_relative_low_coverage(g, v, 5.0, 3 * K),
                      v, None),
        lambda g, v: (jpasses.remove_relative_low_coverage(
            g, v, jnp.float32(5.0), jnp.int32(3 * K)), v, None)),
    "hidden_ec": (hidden_ec_graph, *_both(
        "remove_hidden_ec", uniqueness_length=100,
        unreliability_threshold=2.0, ec_threshold=100.0,
        relative_threshold=3.0)),
    "hidden_ec_meta": (hairpin_graph, *_both(
        "remove_hidden_ec", uniqueness_length=100, relative_threshold=3.0,
        meta=True)),
    "tr_ec": (trec_graph, *_both(
        "remove_tr_ec", max_ec_length=K + 100, uniqueness_length=100,
        unreliable_coverage=2.5)),
    "thorns": (thorn_graph, *_both(
        "remove_thorns", max_ec_length=K + 100, uniqueness_length=50,
        span_distance=15000)),
    "multiplicity_ec": (multiplicity_graph, *_both(
        "remove_multiplicity_ec", max_ec_length=K + 100,
        uniqueness_length=100, plausibility_length=50)),
    "topology_ec_trec": (trec_graph, *_both(
        "remove_topology_ec", max_ec_length=K + 100,
        uniqueness_length=100, plausibility_length=50)),
    "topology_ec_multiplicity": (multiplicity_graph, *_both(
        "remove_topology_ec", max_ec_length=K + 100,
        uniqueness_length=100, plausibility_length=50)),
}


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


@pytest.mark.parametrize("name", list(CASES))
def test_sc_pass_matches_jax(name):
    fixture, port_fn, jax_fn = CASES[name]
    jg, v_space = fixture()
    out, vs, n = port_fn(port_graph(jg), v_space)
    jout, jvs, jn = jax_fn(jg, v_space)
    assert (vs, n) == (jvs, jn)
    assert_graphs_equal(out, jout)
    # every fixture gives its pass something to remove
    assert int(edge_mask(out).sum()) < int(np.asarray(
        jgraph.edge_mask(jg)).sum()) or n


def _uneven_reads(strains):
    """tests/test_coverage_model.py:85-137: 100 bp reads drawn at the
    given coverage from each (size, seed) strain."""
    reads = []
    rng = np.random.default_rng(4 + len(strains))
    for (size, seed), cov in strains:
        genome = simulate.random_genome(size, seed=seed)
        for _ in range(cov * size // 100):
            p = int(rng.integers(0, size - 100))
            reads.append(genome[p:p + 100])
    return dna.encode_reads(reads)


@pytest.mark.parametrize("strains", [
    (((3000, 11), 12), ((3000, 12), 60)),   # two strains, 12x and 60x
    (((2500, 21), 40),),                    # one genome at 40x
])
def test_uneven_depth_matches_jax(strains):
    codes, lengths = _uneven_reads(strains)
    res = assemble.assemble_single_k(codes, lengths, 21, uneven_depth=True,
                                     device="cpu")
    jres = jassemble.assemble_single_k(jnp.asarray(codes),
                                       jnp.asarray(lengths), 21,
                                       uneven_depth=True)
    np.testing.assert_allclose(res.genomic_info.ec_bound,
                               jres.genomic_info.ec_bound, rtol=1e-5)
    canon = [sorted(min(s, dna.revcomp_str(s)) for s, _ in r.contigs)
             for r in (res, jres)]
    assert canon[0] == canon[1] and canon[0]
    # on one graph the finder is exact
    g = port_graph(jres.graph)
    assert ec_threshold.uneven_ec_bound(g) == ject.uneven_ec_bound(
        jres.graph)
    assert np.array_equal(ec_threshold.interesting_edges(g),
                          ject.interesting_edges(jres.graph))


def _sc_uneven_graph():
    """A graph with uneven coverage and MDA-like chimeras for the whole
    sc cycle: two genomes at 8x and 50x, a few chimeric reads."""
    a = simulate.random_genome(3000, seed=31, repeats=[(200, 2)])
    b = simulate.random_genome(2000, seed=32)
    rng = np.random.default_rng(33)
    reads = []
    for genome, cov in ((a, 8), (b, 50)):
        for _ in range(cov * len(genome) // 60):
            p = int(rng.integers(0, len(genome) - 60))
            reads.append(genome[p:p + 60])
    reads += [a[500:530] + nd.rc(a[1500:1530]), a[900:930] + b[700:730]]
    codes, lengths = dna.encode_reads(reads)
    kp1 = jcounter.trim_table(jcounter.count_kmers(
        jnp.asarray(codes), jnp.asarray(lengths), 22))
    vt = jext.trim_vertex_table(jext.build_vertex_table(kp1, 21))
    return jgraph.compact_graph(jcondense.build_graph(kp1, vt, 21))


def test_sc_simplification_cycle_matches_jax():
    jg, v_space = _sc_uneven_graph()
    cfg = config.config_for_mode("sc").simplify
    jcfg = jconfig.config_for_mode("sc").simplify
    cfg, jcfg = (dataclasses.replace(c, read_length=60) for c in (cfg, jcfg))
    out = runner.simplify_graph(port_graph(jg), v_space, 4.0, cfg)
    jout = jrunner.simplify_graph(jg, v_space, 4.0, jcfg)
    assert_graphs_equal(out, jout)


def test_sc_mode_config_matches_jax():
    cfg, jcfg = config.config_for_mode("sc"), jconfig.config_for_mode("sc")
    for f in dataclasses.fields(cfg):
        if f.name not in ("simplify", "pe"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert vars(cfg.pe) == vars(jcfg.pe)
    ported = {f.name for f in dataclasses.fields(cfg.simplify)}
    defaults = jrunner.SimplifyConfig()
    for f in dataclasses.fields(jcfg.simplify):
        want = getattr(jcfg.simplify, f.name)
        if f.name in ported:
            assert getattr(cfg.simplify, f.name) == want, f.name
        else:  # a field of a pass not ported yet: sc leaves it alone
            assert want == getattr(defaults, f.name), f.name
    assert cfg.uneven_depth and cfg.simplify.rcc_enabled \
        and cfg.simplify.tec_enabled and cfg.simplify.her_enabled


def test_sc_command_line_matches_jax(tmp_path):
    genome = simulate.random_genome(6000, seed=61, repeats=[(400, 2)])
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, 900, read_len=100, insert_mean=300, insert_sd=25,
        error_rate=0.002, seed=62)
    p1, p2 = str(tmp_path / "r_1.fq"), str(tmp_path / "r_2.fq")
    simulate.write_fastq(p1, r1, q1)
    simulate.write_fastq(p2, r2, q2)
    argv = ["-1", p1, "-2", p2, "-k", "21", "--sc", "--only-assembler",
            "--checkpoints", "none"]
    assert cli.main(argv + ["-o", str(tmp_path / "port"), "--device",
                            "cpu"]) == 0
    try:
        assert jcli.main(argv + ["-o", str(tmp_path / "jax")]) == 0
    finally:
        jlogger.configure()
    for name in ("contigs.fasta", "scaffolds.fasta", "before_rr.fasta",
                 "assembly_graph_with_scaffolds.gfa", "assembly_graph.fastg",
                 "contigs.paths", "scaffolds.paths"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert "mode: sc" in (tmp_path / "port" / "spades.log").read_text()
