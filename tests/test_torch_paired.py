"""The PyTorch port's paired information and gap closing vs the JAX
package's: the insert-size estimate, the raw paired index, both distance
estimators, split-path filling, the merge of libraries, and the gap
closer, with the gap closer's int32 key pinned where the packages
differ."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from spades_for_blackbird_tpu.graph import graph as jgraph  # noqa: E402
from spades_for_blackbird_tpu.mapping import chunked as jchunked  # noqa: E402
from spades_for_blackbird_tpu.mapping import index as jindex  # noqa: E402
from spades_for_blackbird_tpu.mapping import mapper as jmapper  # noqa: E402
from spades_for_blackbird_tpu.ops import dna as jdna  # noqa: E402
from spades_for_blackbird_tpu.paired import (  # noqa: E402
    insert_size as jinsert_size)
from spades_for_blackbird_tpu.paired import (  # noqa: E402
    pair_info as jpair_info)
from spades_for_blackbird_tpu.pipeline import (  # noqa: E402
    assemble as jassemble)
from spades_for_blackbird_tpu.pipeline import (  # noqa: E402
    gap_closer as jgap_closer)
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import interop  # noqa: E402
from spades_for_blackbird_tpu_torch.mapping import (  # noqa: E402
    chunked, index, mapper)
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.paired import (  # noqa: E402
    insert_size, pair_info)
from spades_for_blackbird_tpu_torch.pipeline import gap_closer  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402
from test_torch_mapping import synthetic_graph  # noqa: E402

INDEX_FIELDS = ("e1", "e2", "dist", "weight")


@pytest.fixture(autouse=True)
def _default_reference_logger():
    """The JAX package logs through one process-wide logger, and a CLI
    test run earlier in the same worker can leave a writer on it whose
    file is closed. These tests start from the default configuration."""
    jlogger.configure()


def _jax_chain(ji, jg, codes, lengths):
    ch = jchunked.map_reads_multi_chunked(ji, jg.seq_len, codes, lengths,
                                          jg.k + 1, min_votes=1)
    return jmapper.normalize_chain(ch, jg.conj)


def _first(ch, cls):
    return cls(ch.oriented_edge[:, 0], ch.start[:, 0], ch.votes[:, 0],
               ch.mapped)


def _make_lib(insert):
    """A 12 kb simulation at k = 21 (the JAX package's assembly) and one
    library of 2,400 pairs of 100 bp (insert ``insert`` +- insert/12),
    mapped by both packages: everything the paired index is made from."""
    genome = simulate.random_genome(12000, seed=31, repeats=[(300, 2)])
    r1, _, r2, _ = simulate.simulate_paired_reads(
        genome, 2400, read_len=100, insert_mean=insert,
        insert_sd=insert / 12, error_rate=0.003, seed=32)
    codes, lengths = dna.encode_reads(r1 + r2)
    jlogger.configure()  # see _default_reference_logger
    mp = pytest.MonkeyPatch()
    mp.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    try:
        jg = jassemble.assemble_single_k(codes, lengths, 21).graph
    finally:
        mp.undo()
        jlogger.configure()
    g = interop.graph_from_numpy(
        interop.fields_of(jg, interop.GRAPH_FIELDS), jg.k, "cpu")
    c1, l1 = dna.encode_reads(r1)
    c2, l2 = dna.encode_reads(r2)
    c2rc = np.array(jdna.revcomp_reads(jnp.asarray(c2), jnp.asarray(l2)))
    ji = jindex.build_edge_index(jg, 22)
    jch = (_jax_chain(ji, jg, c1, l1), _jax_chain(ji, jg, c2rc, l2))
    pi = index.build_edge_index(g, 22, device="cpu")
    pch = tuple(mapper.normalize_chain(chunked.map_reads_multi_chunked(
        pi, g.seq_len, c, l, 22, min_votes=1, device="cpu"), g.conj)
        for c, l in ((c1, l1), (c2rc, l2)))
    return dict(genome=genome, jg=jg, g=g, jch=jch, pch=pch, l2=l2)


@pytest.fixture(scope="module")
def pe_lib():
    return _make_lib(300)


@pytest.fixture(scope="module")
def mp_lib():
    return _make_lib(2000)


@pytest.fixture(params=["pe", "mp"])
def lib(request):
    """Each library in turn: a paired-end one (insert 300) and one with
    the wide insert of a mate-pair library (2000)."""
    return request.getfixturevalue(f"{request.param}_lib")


def _stats(lib):
    j = jinsert_size.estimate_insert_size(
        _first(lib["jch"][0], jmapper.ReadMapping),
        _first(lib["jch"][1], jmapper.ReadMapping), lib["l2"])
    p = insert_size.estimate_insert_size(
        _first(lib["pch"][0], mapper.ReadMapping),
        _first(lib["pch"][1], mapper.ReadMapping), lib["l2"])
    return j, p


def test_insert_size_matches_the_reference(lib):
    j, p = _stats(lib)
    assert vars(p) == vars(j)
    assert p.count > 500
    back = interop.insert_size_stats_from_numpy(
        interop.insert_size_stats_to_numpy(p))
    assert back == p


def _raw(lib):
    j, _ = _stats(lib)
    shift = int(round(j.median - lib["l2"].mean()))
    jraw = jpair_info.fill_paired_index_multi_chunked(
        *lib["jch"], jnp.int32(shift))
    praw = pair_info.fill_paired_index_multi_chunked(*lib["pch"], shift)
    return j, shift, jraw, praw


def _same(ours, theirs, fields=INDEX_FIELDS):
    n = int(theirs.num)
    got = interop.paired_index_to_numpy(ours)
    assert got["num"] == n
    for name in fields:
        np.testing.assert_array_equal(
            got[name][:n], np.asarray(getattr(theirs, name))[:n],
            err_msg=name)
    return got, n


def test_raw_paired_index_matches_the_reference(lib):
    _, shift, jraw, praw = _raw(lib)
    _same(praw, jraw)
    assert int(praw.num) > 100
    # integer counts: the chunk size changes nothing
    small = pair_info.fill_paired_index_multi_chunked(*lib["pch"], shift,
                                                      chunk=333)
    for a, b in zip(small[:5], praw[:5]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def _estimators(stats):
    spread = max(5, int(3 * stats.mad))
    return {"simple": (jpair_info.cluster_distances, (jnp.int32(spread),),
                       pair_info.cluster_distances, (spread,)),
            "smoothing": (jpair_info.cluster_distances_smoothing,
                          (jnp.int32(max(spread, 20)), jnp.float32(2.0)),
                          pair_info.cluster_distances_smoothing,
                          (max(spread, 20), 2.0))}


@pytest.mark.parametrize("estimator", ["simple", "smoothing"])
def test_distance_estimators_match_the_reference(lib, estimator):
    """Both estimators on the same raw index: e1, e2, dist and weight
    exact. ``var`` is d2sum/w - dmean^2 of float32 sums; the JAX package
    adds the group's n terms one by one in float32, the port exactly, so
    the two may differ by the error of a float32 running sum: at most
    n * 2^-23 times the second moment (var + dist^2; +1 for dist 0). The
    port's own estimate is the JAX package's float32 formula on exact
    sums rounded once: equal, bit for bit, to NumPy doing the same."""
    stats, _, jraw, _ = _raw(lib)
    jf, jargs, pf, pargs = _estimators(stats)[estimator]
    theirs = jf(jraw, *jargs)
    ours = pf(interop.paired_index_from_numpy(
        *(np.asarray(getattr(jraw, f)) for f in INDEX_FIELDS), jraw.num),
        *pargs)
    got, n = _same(ours, theirs)
    assert n > 5
    raw = {f: np.asarray(getattr(jraw, f)) for f in INDEX_FIELDS}
    m = int(jraw.num)
    group = raw["e1"][:m].astype(np.int64) << 32 | raw["e2"][:m]
    rows = np.array([np.sum(group == (int(a) << 32 | int(b)))
                     for a, b in zip(got["e1"][:n], got["e2"][:n])])
    var, theirs_var = got["var"][:n], np.asarray(theirs.var)[:n]
    moment = var.astype(np.float64) + got["dist"][:n].astype(np.float64) \
        ** 2 + 1
    assert np.all(np.abs(var - theirs_var) <= rows * 2.0 ** -23 * moment)
    # the port: float32 terms summed exactly, rounded once, then the JAX
    # package's float32 formula -- the same bits as this NumPy
    if estimator == "simple":
        d = raw["dist"][:m].astype(np.float32)
        w = raw["weight"][:m]
        spread = max(5, int(3 * stats.mad))
        for i in range(n):
            sel = ((raw["e1"][:m] == got["e1"][i])
                   & (raw["e2"][:m] == got["e2"][i]))
            heavy = sel & (w == w[sel].max())
            mode = raw["dist"][:m][heavy].min()
            near = sel & (np.abs(raw["dist"][:m] - mode) <= spread)
            wsum, dsum, d2sum = (
                np.stack([w, w * d, w * np.square(d)])[:, near]
                .astype(np.float64).sum(1).astype(np.float32))
            mean = dsum / wsum
            assert got["weight"][i] == wsum
            assert got["dist"][i] == np.round(mean)
            assert var[i] == max(d2sum / wsum - np.square(mean),
                                 np.float32(0))


def test_split_path_fill_and_merge_match_the_reference(lib):
    stats, _, jraw, _ = _raw(lib)
    spread = max(5, int(3 * stats.mad))
    jclu = jpair_info.cluster_distances(jraw, jnp.int32(spread))
    pclu = interop.paired_index_from_numpy(
        *(np.asarray(getattr(jclu, f)) for f in INDEX_FIELDS), jclu.num,
        var=np.asarray(jclu.var))
    jfill = jpair_info.split_path_fill(lib["jg"], jclu, float(stats.median),
                                       float(stats.deviation))
    pfill = pair_info.split_path_fill(lib["g"], pclu, float(stats.median),
                                      float(stats.deviation))
    _same(pfill, jfill)
    jsm = jpair_info.cluster_distances_smoothing(jraw, jnp.int32(20),
                                                 jnp.float32(2.0))
    psm = interop.paired_index_from_numpy(
        *(np.asarray(getattr(jsm, f)) for f in INDEX_FIELDS), jsm.num,
        var=np.asarray(jsm.var))
    jmerged = jpair_info.merge_paired_indices([jfill, jsm])
    pmerged = pair_info.merge_paired_indices([pfill, psm])
    _same(pmerged, jmerged, INDEX_FIELDS + ("var",))


def test_split_path_fill_adds_the_forced_path():
    """A chain A -> M -> B and one clustered point (A, B): every A->B path
    goes through M, so both packages add the point (A, M) at the distance
    less M's length, with half the weight."""
    k = 21
    lens = {0: 500, 2: 150, 4: 500}          # A, M, B; conjugates odd
    seqs = [dna.encode_str("A" * n) for n in lens.values()]
    E = 8
    fields = dict(
        seq_flat=np.zeros(4096, np.uint8),
        seq_start=np.zeros(E, np.int32), seq_len=np.zeros(E, np.int32),
        cov=np.full(E, 10.0, np.float32),
        start_v=np.array([0, 3, 2, 5, 4, 7, 0, 0], np.int32),
        end_v=np.array([2, 1, 4, 3, 6, 5, 0, 0], np.int32),
        conj=np.array([1, 0, 3, 2, 5, 4, 6, 7], np.int32),
        alive=np.arange(E) < 6, num_edges=np.int32(6), flank=None)
    at = 0
    for e, s in zip((0, 2, 4), seqs):
        for x in (e, e + 1):
            fields["seq_start"][x], fields["seq_len"][x] = at, len(s)
            fields["seq_flat"][at:at + len(s)] = s
            at += len(s)
    jg = jgraph.Graph(**{n: jnp.asarray(v) for n, v in fields.items()
                         if v is not None}, k=k)
    g = interop.graph_from_numpy(fields, k, "cpu")
    d = (lens[0] - k) + (lens[2] - k) + 2
    point = [np.array([v], np.int32) for v in (0, 8, d)] + [
        np.array([10.0], np.float32)]
    theirs = jpair_info.split_path_fill(
        jg, jpair_info.PairedIndex(*(jnp.asarray(a) for a in point),
                                   num=jnp.int32(1)), 700.0, 20.0)
    ours = pair_info.split_path_fill(
        g, interop.paired_index_from_numpy(*point, 1), 700.0, 20.0)
    got, n = _same(ours, theirs)
    assert n == 2 and (0, 4, d - (lens[2] - k), 5.0) in zip(
        got["e1"], got["e2"], got["dist"], got["weight"])


def _gap_graph(capacity, first_id):
    """Two edges that the reads show adjacent but the graph does not
    join: the genome's first 1,530 bases and the rest from base 1,500,
    which overlap by 30 bases; and 600 read pairs over the genome."""
    rng = np.random.default_rng(41)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    fields, jg = synthetic_graph([genome[:1530], genome[1500:]], 21,
                                 capacity, first_id, covs=[12.0, 9.0])
    r1, _, r2, _ = simulate.simulate_paired_reads(
        genome, 600, read_len=100, insert_mean=300, insert_sd=25,
        error_rate=0.0, seed=42)
    c1, l1 = dna.encode_reads(r1)
    c2, l2 = dna.encode_reads(r2)
    return fields, jg, genome, (c1, l1, c2, l2)


def _graph_equal(g, jg):
    ours = interop.graph_to_saved_arrays(g)
    for name, value in ours.items():
        theirs = np.asarray(getattr(jg, name))
        np.testing.assert_array_equal(value, theirs, err_msg=name)


def test_close_gaps_matches_the_reference():
    """At capacity 2^6 the JAX package's int32 key is exact: both join
    the two edges into the genome, into the same graph."""
    fields, jg, genome, reads = _gap_graph(64, 6)
    g = interop.graph_from_numpy(fields, 21, "cpu")
    g2, joined = gap_closer.close_gaps(g, *reads, device="cpu")
    jg2, jjoined = jgap_closer.close_gaps(jg, *reads)
    assert joined == jjoined == 1
    _graph_equal(g2, jg2)
    seqs = {dna.decode_codes(g2.seq_flat[s:s + n].numpy())
            for s, n, a in zip(g2.seq_start.tolist(), g2.seq_len.tolist(),
                               g2.alive.tolist()) if a}
    assert genome in seqs and dna.revcomp_str(genome) in seqs


def test_close_gaps_on_an_assembled_graph_matches_the_reference(pe_lib):
    jg, g = pe_lib["jg"], pe_lib["g"]
    r1, _, r2, _ = simulate.simulate_paired_reads(
        pe_lib["genome"], 600, read_len=100, insert_mean=300,
        insert_sd=25, error_rate=0.003, seed=33)
    reads = (*dna.encode_reads(r1), *dna.encode_reads(r2))
    g2, joined = gap_closer.close_gaps(g, *reads, device="cpu")
    jg2, jjoined = jgap_closer.close_gaps(jg, *reads)
    assert joined == jjoined
    _graph_equal(g2, jg2)


def test_gap_closer_int32_key_divergence():
    """ROADMAP.md, Queue 3, item 2: the JAX package's support key
    p1 * E + p2 runs in int32. At capacity E = 2^16, with the dead end's
    id p1 >= 32768, p1 * E passes 2^31, the key wraps negative and the
    pair is dropped: the JAX package joins nothing. The port's key is
    int64 and joins the edges, as it does at a small capacity."""
    fields, jg, genome, reads = _gap_graph(1 << 16, 40000)
    g = interop.graph_from_numpy(fields, 21, "cpu")
    jg2, jjoined = jgap_closer.close_gaps(jg, *reads)
    assert jjoined == 0
    assert 40000 * (1 << 16) >= 1 << 31
    g2, joined = gap_closer.close_gaps(g, *reads, device="cpu")
    assert joined == 1
    seqs = {dna.decode_codes(g2.seq_flat[s:s + n].numpy())
            for s, n, a in zip(g2.seq_start.tolist(), g2.seq_len.tolist(),
                               g2.alive.tolist()) if a}
    assert genome in seqs


def test_without_a_card_the_gap_closer_refuses():
    if torch.cuda.is_available():
        pytest.skip("shows the refusal on a machine without a card")
    fields, _, _, reads = _gap_graph(64, 6)
    g = interop.graph_from_numpy(fields, 21, "cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        gap_closer.close_gaps(g, *reads)
