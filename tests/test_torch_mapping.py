"""The PyTorch port's read-to-graph mapping vs the JAX package's: the
edge k-mer index, the single-placement and chain mappings, their
normalisation, and mapping in chunks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from spades_for_blackbird_tpu.graph import graph as jgraph  # noqa: E402
from spades_for_blackbird_tpu.mapping import index as jindex  # noqa: E402
from spades_for_blackbird_tpu.mapping import mapper as jmapper  # noqa: E402
from spades_for_blackbird_tpu.ops import dna as jdna  # noqa: E402
from spades_for_blackbird_tpu.pipeline import (  # noqa: E402
    assemble as jassemble)
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import interop  # noqa: E402
from spades_for_blackbird_tpu_torch.mapping import (  # noqa: E402
    chunked, index, mapper)
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402


@pytest.fixture(autouse=True)
def _default_reference_logger():
    """The JAX package logs through one process-wide logger, and a CLI
    test run earlier in the same worker can leave a writer on it whose
    file is closed. These tests start from the default configuration."""
    jlogger.configure()


def synthetic_graph(seqs, k, capacity, first_id, covs=None):
    """Numpy fields of a graph whose edges are ``seqs`` and their reverse
    complements (edge first_id + 2i and its conjugate first_id + 2i + 1),
    each edge between vertices of its own, so every edge is both a dead
    end and a dead start. Returns (fields for ``interop.graph_from_numpy``,
    the JAX package's Graph)."""
    E = capacity
    flat, start = [], np.zeros(E, np.int32)
    seq_len = np.zeros(E, np.int32)
    cov = np.zeros(E, np.float32)
    start_v = np.zeros(E, np.int32)
    end_v = np.zeros(E, np.int32)
    conj = np.arange(E, dtype=np.int32)
    alive = np.zeros(E, bool)
    at = 0
    for i, s in enumerate(seqs):
        a = first_id + 2 * i
        for e, text in ((a, s), (a + 1, dna.revcomp_str(s))):
            start[e], seq_len[e] = at, len(text)
            flat.append(dna.encode_str(text))
            at += len(text)
            cov[e] = 10.0 if covs is None else covs[i]
            alive[e] = True
        conj[a], conj[a + 1] = a + 1, a
        start_v[a], end_v[a] = 4 * i, 4 * i + 2
        start_v[a + 1], end_v[a + 1] = (4 * i + 2) ^ 1, (4 * i) ^ 1
    seq_flat = np.zeros(1 << max(at - 1, 1).bit_length(), np.uint8)
    seq_flat[:at] = np.concatenate(flat)
    fields = dict(seq_flat=seq_flat, seq_start=start, seq_len=seq_len,
                  cov=cov, start_v=start_v, end_v=end_v, conj=conj,
                  alive=alive,
                  num_edges=np.int32(first_id + 2 * len(seqs)), flank=None)
    jg = jgraph.Graph(**{name: jnp.asarray(v) for name, v in fields.items()
                         if v is not None}, k=k)
    return fields, jg


def _reads(size, n_pairs, seed, read_len=100):
    genome = simulate.random_genome(size, seed=seed, repeats=[(300, 2)])
    r1, _, r2, _ = simulate.simulate_paired_reads(
        genome, n_pairs, read_len=read_len, insert_mean=300, insert_sd=25,
        error_rate=0.003, seed=seed + 1)
    return genome, r1, r2


@pytest.fixture(scope="module")
def graphs():
    """A k = 21 graph of an 8 kb simulation (JAX package's single-K
    assembly) in both packages, with 1,000 read pairs of 100 bp."""
    jlogger.configure()  # see _default_reference_logger
    mp = pytest.MonkeyPatch()
    mp.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    try:
        _, r1, r2 = _reads(8000, 1200, seed=21)
        codes, lengths = dna.encode_reads(r1 + r2)
        jg = jassemble.assemble_single_k(codes, lengths, 21).graph
    finally:
        mp.undo()
        jlogger.configure()
    g = interop.graph_from_numpy(
        interop.fields_of(jg, interop.GRAPH_FIELDS), jg.k, "cpu")
    rc, rl = dna.encode_reads(r1[:1000] + r2[:1000])
    return jg, g, rc, rl


def _same_index(pi, ji):
    ours = interop.edge_index_to_numpy(pi)
    n = int(ji.num)
    assert ours["num"] == n
    for name, theirs in (("kmers", ji.kmers), ("edge", ji.edge),
                         ("offset", ji.offset), ("is_fwd", ji.is_fwd)):
        np.testing.assert_array_equal(ours[name][:n],
                                      np.asarray(theirs)[:n], err_msg=name)


@pytest.mark.parametrize("kp1", [22, 56])
def test_edge_index_matches_the_reference(graphs, kp1):
    jg, g, _, _ = graphs
    pi = index.build_edge_index(g, kp1, device="cpu")
    ji = jindex.build_edge_index(jg, kp1)
    _same_index(pi, ji)
    # every k-mer sits in an edge and in its conjugate: the stable sort
    # keeps them in flat order, and a lookup finds the first of them
    keys = pi.keys[:, :int(pi.num)]
    assert torch.unique(keys, dim=1).shape[1] < int(pi.num)
    words = interop.edge_index_to_numpy(pi)["kmers"][:int(pi.num)]
    row, found, edge, off = index.lookup_kmers(
        pi, torch.from_numpy(words.astype(np.int64)))
    jrow, jfound, jedge, joff = jindex.lookup_kmers(ji, jnp.asarray(words))
    assert bool(found.all())
    for a, b in ((row, jrow), (edge, jedge), (off, joff)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_edge_index_of_a_kmer_shared_by_two_edges():
    """Two edges that share 40 bases (a repeat the graph kept apart): the
    shared 22-mers have a row in each edge, in flat order."""
    rng = np.random.default_rng(3)
    shared = "".join(rng.choice(list("ACGT"), 40))
    a, b, c = ("".join(rng.choice(list("ACGT"), n)) for n in (70, 90, 50))
    fields, jg = synthetic_graph([a + shared + b, c + shared], 21, 64, 6)
    g = interop.graph_from_numpy(fields, 21, "cpu")
    pi = index.build_edge_index(g, 22, device="cpu")
    ji = jindex.build_edge_index(jg, 22)
    _same_index(pi, ji)
    edges_of_shared = {}
    n = int(pi.num)
    keys = [tuple(col) for col in pi.keys[:, :n].T.tolist()]
    for r in range(n):
        edges_of_shared.setdefault(keys[r], set()).add(int(pi.edge[r]))
    assert max(len(v) for v in edges_of_shared.values()) == 4


def test_map_reads_matches_the_reference(graphs):
    jg, g, codes, lengths = graphs
    K = jg.k + 1
    pi = index.build_edge_index(g, K, device="cpu")
    ji = jindex.build_edge_index(jg, K)
    c2 = jdna.revcomp_reads(jnp.asarray(codes), jnp.asarray(lengths))
    for c in (codes, np.array(c2)):
        ours = mapper.normalize_mapping(
            mapper.map_reads(pi, g.seq_len, torch.from_numpy(c),
                             torch.from_numpy(lengths), K), g.conj)
        theirs = jmapper.normalize_mapping(
            jmapper.map_reads(ji, jg.seq_len, jnp.asarray(c),
                              jnp.asarray(lengths), K), jg.conj)
        got = interop.read_mapping_to_numpy(ours)
        for name in theirs._fields:
            np.testing.assert_array_equal(got[name],
                                          np.asarray(getattr(theirs, name)),
                                          err_msg=name)
        assert got["mapped"].mean() > 0.9


@pytest.mark.parametrize("min_votes", [1, 2])
def test_map_reads_multi_matches_the_reference(graphs, min_votes):
    jg, g, codes, lengths = graphs
    K = jg.k + 1
    pi = index.build_edge_index(g, K, device="cpu")
    ji = jindex.build_edge_index(jg, K)
    ours = mapper.normalize_chain(mapper.map_reads_multi(
        pi, g.seq_len, torch.from_numpy(codes), torch.from_numpy(lengths),
        K, min_votes=min_votes), g.conj)
    theirs = jmapper.normalize_chain(jmapper.map_reads_multi(
        ji, jg.seq_len, jnp.asarray(codes), jnp.asarray(lengths), K,
        min_votes=min_votes), jg.conj)
    got = interop.chain_mapping_to_numpy(ours)
    for name in theirs._fields:
        np.testing.assert_array_equal(got[name],
                                      np.asarray(getattr(theirs, name)),
                                      err_msg=name)
    # reads across a junction place on more than one edge
    assert (got["chain_len"] > 1).any()
    back = interop.chain_mapping_from_numpy(got)
    assert all(torch.equal(a, b) for a, b in zip(back, ours))


@pytest.mark.parametrize("chunk", [97, 512])
def test_chunked_mapping_equals_one_shot(graphs, chunk):
    jg, g, codes, lengths = graphs
    K = jg.k + 1
    pi = index.build_edge_index(g, K, device="cpu")
    one = mapper.map_reads(pi, g.seq_len, torch.from_numpy(codes),
                           torch.from_numpy(lengths), K)
    many = chunked.map_reads_chunked(pi, g.seq_len, codes, lengths, K,
                                     chunk=chunk, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(one, many))
    one = mapper.map_reads_multi(pi, g.seq_len, torch.from_numpy(codes),
                                 torch.from_numpy(lengths), K, min_votes=1)
    many = chunked.map_reads_multi_chunked(pi, g.seq_len, codes, lengths,
                                           K, min_votes=1, chunk=chunk,
                                           device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(one, many))


def test_index_crosses_between_the_packages(graphs):
    jg, g, _, _ = graphs
    ji = jindex.build_edge_index(jg, 22)
    pi = interop.edge_index_from_numpy(ji.kmers, ji.edge, ji.offset,
                                       ji.is_fwd, ji.num, 22)
    n = int(ji.num)
    ours = index.build_edge_index(g, 22, device="cpu")
    assert torch.equal(pi.keys[:, :n], ours.keys[:, :n])
    assert torch.equal(pi.edge[:n], ours.edge[:n])


def test_without_a_card_the_mapping_entry_points_refuse(graphs):
    if torch.cuda.is_available():
        pytest.skip("shows the refusal on a machine without a card")
    _, g, codes, lengths = graphs
    with pytest.raises(RuntimeError, match="CUDA card"):
        index.build_edge_index(g, 22)
    pi = index.build_edge_index(g, 22, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        chunked.map_reads_chunked(pi, g.seq_len, codes, lengths, 22,
                                  device="cuda")
