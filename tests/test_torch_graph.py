"""PyTorch port vs the JAX package: vertex table, early tips, pointer
jumping, condensation and every simplification pass of the slice.

Each port stage is fed the JAX package's own intermediate state through
``spades_for_blackbird_tpu_torch.interop``, so a divergence shows at the
stage that causes it. Integer results must be bit-equal. Coverage after
a pass is compared with rtol 1e-5: the float32 sums of recondense and
bulge projection may be taken in another order than XLA's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: more intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from spades_for_blackbird_tpu.graph import condense as jcondense  # noqa: E402
from spades_for_blackbird_tpu.graph import graph as jgraph  # noqa: E402
from spades_for_blackbird_tpu.graph import pointer_jump as jpj  # noqa: E402
from spades_for_blackbird_tpu.kmers import counter as jcounter  # noqa: E402
from spades_for_blackbird_tpu.kmers import early_tips as jtips  # noqa: E402
from spades_for_blackbird_tpu.kmers import extension as jext  # noqa: E402
from spades_for_blackbird_tpu.simplify import advanced as jadv  # noqa: E402
from spades_for_blackbird_tpu.simplify import passes as jpasses  # noqa: E402
from spades_for_blackbird_tpu.simplify import recondense as jrec  # noqa: E402
from spades_for_blackbird_tpu.simplify import runner as jrunner  # noqa: E402
from spades_for_blackbird_tpu_torch import interop  # noqa: E402
from spades_for_blackbird_tpu_torch.graph import condense, graph  # noqa: E402
from spades_for_blackbird_tpu_torch.graph import pointer_jump  # noqa: E402
from spades_for_blackbird_tpu_torch.kmers import early_tips  # noqa: E402
from spades_for_blackbird_tpu_torch.kmers import extension  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.simplify import advanced  # noqa: E402
from spades_for_blackbird_tpu_torch.simplify import passes  # noqa: E402
from spades_for_blackbird_tpu_torch.simplify import recondense  # noqa: E402
from spades_for_blackbird_tpu_torch.simplify import runner  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

READ_LEN = 60
COV_RTOL = 1e-5  # float32 sums in another order than XLA's


def _reads(seed):
    genome = simulate.random_genome(4000, seed=seed, repeats=[(200, 2)])
    r1, _, r2, _ = simulate.simulate_paired_reads(
        genome, 1200, read_len=READ_LEN, insert_mean=200, insert_sd=15,
        error_rate=0.005, seed=seed + 1)
    return dna.encode_reads(r1 + r2)


@pytest.fixture(scope="module", params=[21, 33])
def state(request):
    """JAX-built state at one k: (k+1)-mer table, vertex table, raw and
    compacted graph (no early tip clipping, so the passes have work)."""
    k = request.param
    codes, lengths = _reads(k)
    kp1 = jcounter.trim_table(jcounter.count_kmers(
        jnp.asarray(codes), jnp.asarray(lengths), k + 1))
    vt = jext.trim_vertex_table(jext.build_vertex_table(kp1, k))
    g = jcondense.build_graph(kp1, vt, k)
    gc, v_space = jgraph.compact_graph(g)
    return {"k": k, "kp1": kp1, "vt": vt, "graph": g, "compact": gc,
            "v_space": v_space}


def port_table(jt):
    return interop.kmer_table_from_numpy(
        np.asarray(jt.kmers), np.asarray(jt.counts), int(jt.num))


def port_vt(jvt):
    return interop.vertex_table_from_numpy(
        np.asarray(jvt.kmers), np.asarray(jvt.out_mask),
        np.asarray(jvt.in_mask), int(jvt.num))


def port_graph(jg):
    return interop.graph_from_numpy(
        interop.fields_of(jg, interop.GRAPH_FIELDS), jg.k)


def assert_graphs_equal(g, jg, cov_rtol=0.0):
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
            np.testing.assert_allclose(a[name], b[name], rtol=cov_rtol,
                                       atol=0.0, err_msg=name)


def test_vertex_table_matches_jax(state):
    k = state["k"]
    vt = extension.trim_vertex_table(
        extension.build_vertex_table(port_table(state["kp1"]), k))
    a, jvt = interop.vertex_table_to_numpy(vt), state["vt"]
    n = int(jvt.num)
    assert a["num"] == n and vt.capacity == jvt.capacity
    assert np.array_equal(a["kmers"], np.asarray(jvt.kmers))
    assert np.array_equal(a["out_mask"][:n], np.asarray(jvt.out_mask)[:n])
    assert np.array_equal(a["in_mask"][:n], np.asarray(jvt.in_mask)[:n])


def test_early_tip_mask_matches_jax(state):
    k = state["k"]
    bound = READ_LEN - k
    kill = early_tips._tip_kill_mask(port_table(state["kp1"]),
                                     port_vt(state["vt"]), k, bound)
    jkill = jtips._tip_kill_mask(state["kp1"], state["vt"], k,
                                 jnp.int32(bound))
    assert np.array_equal(kill.numpy(), np.asarray(jkill))
    assert kill.any()
    t, n = early_tips.clip_early_tips(port_table(state["kp1"]),
                                      port_vt(state["vt"]), k, bound)
    jt, jn = jtips.clip_early_tips(state["kp1"], state["vt"], k, bound)
    assert n == jn
    a = interop.kmer_table_to_numpy(t)
    assert a["num"] == int(jt.num)
    assert np.array_equal(a["kmers"], np.asarray(jt.kmers))
    assert np.array_equal(a["counts"], np.asarray(jt.counts))


def test_condensed_graph_matches_jax(state):
    k = state["k"]
    g = condense.build_graph(port_table(state["kp1"]), port_vt(state["vt"]),
                             k)
    assert_graphs_equal(g, state["graph"])
    gc, v_space = graph.compact_graph(g)
    assert v_space == state["v_space"]
    assert_graphs_equal(gc, state["compact"])


def test_contract_chains_matches_jax():
    rng = np.random.default_rng(0)
    N = 200
    succ = rng.permutation(N)           # injective: chains and cycles
    succ[rng.random(N) < 0.15] = N      # broken links end chains
    succ[succ == np.arange(N)] = N
    conj = np.arange(N) ^ 1
    valid = np.ones(N, bool)
    ch = pointer_jump.contract_chains(torch.from_numpy(succ),
                                      torch.from_numpy(conj),
                                      torch.from_numpy(valid))
    jch = jpj.contract_chains(jnp.asarray(succ, jnp.int32),
                              jnp.asarray(conj, jnp.int32),
                              jnp.asarray(valid))
    for name in ("rep", "off", "is_start", "cyclic"):
        assert np.array_equal(getattr(ch, name).numpy(),
                              np.asarray(getattr(jch, name))), name
    vals = rng.integers(0, 50, N)
    s = pointer_jump.chain_exclusive_sum(torch.from_numpy(succ), ch.is_start,
                                         torch.from_numpy(valid),
                                         torch.from_numpy(vals))
    js = jpj.chain_exclusive_sum(jnp.asarray(succ, jnp.int32), jch.is_start,
                                 jnp.asarray(valid),
                                 jnp.asarray(vals, jnp.int32))
    assert np.array_equal(s.numpy(), np.asarray(js))


def test_slot_owner_matches_jax(state):
    jg = state["compact"]
    g = port_graph(jg)
    m = graph.edge_mask(g)
    got = graph.slot_owner(g.seq_start, m, g.seq_flat.shape[0])
    ref = jgraph.slot_owner(jg.seq_start, jgraph.edge_mask(jg),
                            jg.seq_flat.shape[0])
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_degrees_match_jax(state):
    jg, v_space = state["compact"], state["v_space"]
    out_deg, in_deg = graph.degrees(port_graph(jg), v_space)
    jout, jin = jgraph.degrees(jg, v_space)
    assert np.array_equal(out_deg.numpy(), np.asarray(jout))
    assert np.array_equal(in_deg.numpy(), np.asarray(jin))


def _tip_len(k):
    return runner._tip_length(k, READ_LEN, 2.0)


PASSES = {
    # name: (port call, JAX call), both on (graph, v_space, k)
    "clip_tips": (
        lambda g, v, k: passes.clip_tips(g, v, _tip_len(k), 4.0, 2.0),
        lambda g, v, k: jpasses.clip_tips(g, v, jnp.int32(_tip_len(k)),
                                          jnp.float32(4.0),
                                          jnp.float32(2.0))),
    "remove_bulges": (
        lambda g, v, k: passes.remove_bulges(g, v, 3 * k, 0.1, 1000.0),
        lambda g, v, k: jpasses.remove_bulges(g, v, jnp.int32(3 * k),
                                              jnp.float32(0.1),
                                              jnp.float32(1000.0))),
    "remove_erroneous_connections": (
        lambda g, v, k: passes.remove_erroneous_connections(g, v, 2 * k, 5.0),
        lambda g, v, k: jpasses.remove_erroneous_connections(
            g, v, jnp.int32(2 * k), jnp.float32(5.0))),
    "remove_isolated": (
        lambda g, v, k: passes.remove_isolated(g, v, READ_LEN, 1e18),
        lambda g, v, k: jpasses.remove_isolated(g, v, jnp.int32(READ_LEN),
                                                jnp.float32(1e18))),
    "recondense": (
        lambda g, v, k: recondense.recondense(
            passes.clip_tips(g, v, _tip_len(k), 4.0, 2.0), v),
        lambda g, v, k: jrec.recondense(
            jpasses.clip_tips(g, v, jnp.int32(_tip_len(k)),
                              jnp.float32(4.0), jnp.float32(2.0)), v)),
    "clip_complex_tips": (
        lambda g, v, k: advanced.clip_complex_tips(
            g, v, max_edge_len=100, max_path_len=_tip_len(k))[0],
        lambda g, v, k: jadv.clip_complex_tips(
            g, v, max_edge_len=100, max_path_len=_tip_len(k))[0]),
    "remove_path_bulges": (
        lambda g, v, k: advanced.remove_path_bulges(g, v,
                                                    max_length=3 * k)[0],
        lambda g, v, k: jadv.remove_path_bulges(g, v, max_length=3 * k)[0]),
    "simplify_graph": (
        lambda g, v, k: runner.simplify_graph(
            g, v, 4.0, runner.SimplifyConfig(read_length=READ_LEN)),
        lambda g, v, k: jrunner.simplify_graph(
            g, v, 4.0, jrunner.SimplifyConfig(read_length=READ_LEN))),
}


@pytest.mark.parametrize("name", list(PASSES))
def test_simplification_pass_matches_jax(state, name):
    port_fn, jax_fn = PASSES[name]
    k, v_space, jg = state["k"], state["v_space"], state["compact"]
    out = port_fn(port_graph(jg), v_space, k)
    jout = jax_fn(jg, v_space, k)
    assert_graphs_equal(out, jout, cov_rtol=COV_RTOL)
    if name != "simplify_graph":
        return
    # the cycle removed something and left the same alive edges
    assert int(graph.edge_mask(out).sum()) < int(graph.edge_mask(
        port_graph(jg)).sum())


def test_unported_branches_raise():
    """Every branch of SimplifyConfig is ported: the refusal of the
    max-flow EC remover is gone, and the cycle with mfec (beside red,
    the low-complexity clippers and superbubbles) gives the JAX
    package's graph."""
    assert not hasattr(runner, "check_ported")
    codes, lengths = _reads(21)
    kp1 = jcounter.trim_table(jcounter.count_kmers(
        jnp.asarray(codes), jnp.asarray(lengths), 22))
    vt = jext.trim_vertex_table(jext.build_vertex_table(kp1, 21))
    jg, v_space = jgraph.compact_graph(jcondense.build_graph(kp1, vt, 21))
    kw = dict(read_length=60, mfec_enabled=True, red_enabled=True,
              low_complexity_enabled=True, superbubble_enabled=True)
    out = runner.simplify_graph(port_graph(jg), v_space, 3.0,
                                runner.SimplifyConfig(**kw))
    jout = jrunner.simplify_graph(jg, v_space, 3.0,
                                  jrunner.SimplifyConfig(**kw))
    assert_graphs_equal(out, jout, cov_rtol=COV_RTOL)
