"""The PyTorch port's max-flow EC remover (mfec) vs the JAX package.

``advanced.remove_max_flow_ec`` on the fixtures of
``tests/test_advanced_simplification.py`` (the cross edge between two
unique-flanked paths, and the incomplete flow that deletes nothing),
the runner's mfec section inside ``simplify_graph``, and
``assemble_single_k`` with ``SimplifyConfig(mfec_enabled=True)``. Edge
tables must be bit-equal; coverages within rtol 1e-5 (float32 sums of
recondense in another order than XLA's).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from spades_for_blackbird_tpu.graph import condense as jcondense  # noqa: E402
from spades_for_blackbird_tpu.graph import graph as jgraph  # noqa: E402
from spades_for_blackbird_tpu.kmers import counter as jcounter  # noqa: E402
from spades_for_blackbird_tpu.kmers import extension as jext  # noqa: E402
from spades_for_blackbird_tpu.pipeline import assemble as jassemble  # noqa: E402
from spades_for_blackbird_tpu.simplify import advanced as jadv  # noqa: E402
from spades_for_blackbird_tpu.simplify import runner as jrunner  # noqa: E402
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import interop  # noqa: E402
from spades_for_blackbird_tpu_torch.graph.graph import edge_mask  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import assemble  # noqa: E402
from spades_for_blackbird_tpu_torch.simplify import advanced  # noqa: E402
from spades_for_blackbird_tpu_torch.simplify import runner  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

K = 15
COV_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    jlogger.configure()


def random_dna(n, seed):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), size=n))


def cover(genome, read_len=50, step=5, times=1):
    return [genome[i:i + read_len]
            for i in range(0, len(genome) - read_len + 1, step)] * times


def compact_graph(reads):
    """tests/test_advanced_simplification.py::build_graph."""
    codes, lengths = dna.encode_reads(reads)
    kp1 = jcounter.count_kmers(codes, lengths, K + 1)
    vt = jext.build_vertex_table(kp1, K)
    return jgraph.compact_graph(jcondense.build_graph(kp1, vt, K))


def cross_edge_graph():
    """tests/test_advanced_simplification.py:183-199."""
    a, b, c, d = (random_dna(120, s) for s in (31, 32, 33, 34))
    g1, g2 = a + b, c + d
    cross = g1[120 - K:120] + g2[120:120 + K]
    return compact_graph(cover(g1, times=3) + cover(g2, times=3)
                         + [cross, cross])


def incomplete_flow_graph():
    """tests/test_advanced_simplification.py:210-221."""
    g1 = random_dna(120, 41) + random_dna(120, 42)
    return compact_graph(cover(g1, times=3) + [g1[120 - K:120] + g1[:K]])


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


@pytest.mark.parametrize("fixture,uniqueness,removes", [
    (cross_edge_graph, 50, True),
    (incomplete_flow_graph, 10_000, False)])
def test_max_flow_ec_matches_jax(fixture, uniqueness, removes):
    jg, v_space = fixture()
    kw = dict(max_ec_length=30, uniqueness_length=uniqueness,
              plausibility_length=20)
    out, vs, n = advanced.remove_max_flow_ec(port_graph(jg), v_space, **kw)
    jout, jvs, jn = jadv.remove_max_flow_ec(jg, v_space, **kw)
    assert (vs, n) == (jvs, jn)
    assert (n >= 1) == removes
    assert_graphs_equal(out, jout)


def test_runner_mfec_section_matches_jax():
    """``simplify_graph`` with only the mfec section beside the cycle:
    the JAX runner's call and arguments (k + mfec_max_ec_len_additive)."""
    jg, v_space = cross_edge_graph()
    kw = dict(read_length=50, mfec_enabled=True, mfec_uniqueness_length=50,
              mfec_plausibility_length=20, rounds=1)
    out = runner.simplify_graph(port_graph(jg), v_space, 2.0,
                                runner.SimplifyConfig(**kw))
    jout = jrunner.simplify_graph(jg, v_space, 2.0,
                                  jrunner.SimplifyConfig(**kw))
    assert_graphs_equal(out, jout)


def test_mfec_config_fields_match_jax():
    port = [(f.name, f.default) for f in
            dataclasses.fields(runner.SimplifyConfig)
            if f.name.startswith("mfec_")]
    jax = [(f.name, f.default) for f in
           dataclasses.fields(jrunner.SimplifyConfig)
           if f.name.startswith("mfec_")]
    assert port == jax and len(port) == 4
    assert not hasattr(runner, "check_ported")


def _chimeric_reads():
    """Two genomes at 30x with a few chimeric reads joining them (an MDA
    library's erroneous connections)."""
    a = simulate.random_genome(4000, seed=71, repeats=[(300, 2)])
    b = simulate.random_genome(3000, seed=72)
    rng = np.random.default_rng(73)
    reads = []
    for genome in (a, b):
        for _ in range(30 * len(genome) // 60):
            p = int(rng.integers(0, len(genome) - 60))
            reads.append(genome[p:p + 60])
    reads += [a[1000:1030] + b[1500:1530]] * 2
    return dna.encode_reads(reads)


@pytest.mark.parametrize("extra", [{}, {"red_enabled": True},
                                   {"superbubble_enabled": True}])
def test_single_k_with_mfec_matches_jax(extra):
    codes, lengths = _chimeric_reads()
    kw = dict(read_length=60, mfec_enabled=True, **extra)
    res = assemble.assemble_single_k(
        codes, lengths, 21, cfg=runner.SimplifyConfig(**kw), device="cpu")
    jres = jassemble.assemble_single_k(
        codes, lengths, 21, cfg=jrunner.SimplifyConfig(**kw))

    def canon(contigs):
        return sorted(min(s, dna.revcomp_str(s)) for s, _ in contigs)
    assert canon(res.contigs) == canon(jres.contigs)
    assert int(edge_mask(res.graph).sum()) == int(np.asarray(
        jgraph.edge_mask(jres.graph)).sum())
