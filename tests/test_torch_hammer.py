"""PyTorch port vs the JAX package: BayesHammer and IonHammer.

The same reads, qualities and intermediate state (carried across with
``interop``) go through both packages. Integer results (tables, cluster
labels, flags, corrected reads, stats) must be equal; float statistics
agree within rtol 1e-5 (float32 sums in another order: XLA's cumsum is a
windowed reduction, torch's a running sum, and exp/log differ in the
last bit) and exactly where they are sums of integers (``qual_sum``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from spades_for_blackbird_tpu.hammer import bayes as jbayes  # noqa: E402
from spades_for_blackbird_tpu.hammer import cluster as jcluster  # noqa: E402
from spades_for_blackbird_tpu.hammer import correct as jcorrect  # noqa: E402
from spades_for_blackbird_tpu.hammer import ionhammer as jion  # noqa: E402
from spades_for_blackbird_tpu.kmers import counter as jcounter  # noqa: E402
from spades_for_blackbird_tpu.ops import kmer as jkmer  # noqa: E402
from spades_for_blackbird_tpu.ops import segments as jseg  # noqa: E402
from spades_for_blackbird_tpu_torch import interop  # noqa: E402
from spades_for_blackbird_tpu_torch.hammer import (  # noqa: E402
    bayes, cluster, correct, ionhammer)
from spades_for_blackbird_tpu_torch.kmers import counter  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import (  # noqa: E402
    dna, kmer, kmer_cuda, segments)
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

K = 21
FLOAT_RTOL = 1e-5


def u32(t):
    return t.cpu().numpy().astype(np.uint32)


def t(a):
    return torch.from_numpy(np.array(a))


def simulated(size=3000, seed=7, read_len=100, error_rate=0.01):
    """Reads with qualities from ``utils/simulate`` (codes, lengths,
    phred+33 quals), a few of them short and padded."""
    genome = simulate.random_genome(size, seed=seed, repeats=[(150, 2)])
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, int(20 * size / (2 * read_len)), read_len=read_len,
        error_rate=error_rate, seed=seed + 1)
    codes, lengths = dna.encode_reads(r1 + r2)
    quals = np.frombuffer("".join(q1 + q2).encode(), np.uint8).reshape(
        codes.shape).copy()
    lengths[3::17] = read_len // 2
    codes[np.arange(read_len)[None, :] >= lengths[:, None]] = \
        dna.INVALID_CODE
    quals[np.arange(read_len)[None, :] >= lengths[:, None]] = 0
    return codes, lengths, quals


@pytest.fixture(autouse=True)
def _single_device_reference(monkeypatch):
    """The port mirrors the JAX package's single-device branch (the
    sharded corrector is Queue 1 g)."""
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")


@pytest.fixture(scope="module")
def reads():
    return simulated()


@pytest.fixture(scope="module")
def counted(reads):
    """The JAX package's counted table and statistics, and the same as
    the port's structures."""
    codes, lengths, quals = reads
    jt, js = jbayes.count_kmers_stats_chunked(codes, lengths, quals, K)
    table = interop.kmer_table_from_numpy(jt.kmers, jt.counts, jt.num)
    stats = interop.qual_stats_from_numpy(js.total_lq, js.qual_sum)
    return jt, js, table, stats


@pytest.fixture(scope="module")
def clustered(counted):
    jt, js, table, stats = counted
    jcl = jcluster.cluster_kmers(jt.kmers, jt.counts, jt.num, K,
                                 jnp.int32(2 ** 30), jnp.float32(0.0))
    jsub = jbayes.subcluster_kmers(jt.kmers, jt.counts, jt.num, js,
                                   jcl.rep, K)
    return jcl, jsub


def assert_stats_match(jt, js, table, stats):
    n = int(jt.num)
    assert int(table.num) == n
    assert table.capacity == jt.kmers.shape[0]
    assert np.array_equal(u32(table.kmers), np.asarray(jt.kmers))
    assert np.array_equal(table.counts.numpy(), np.asarray(jt.counts))
    assert np.array_equal(stats.qual_sum.numpy()[:n],
                          np.asarray(js.qual_sum)[:n])
    np.testing.assert_allclose(stats.total_lq.numpy()[:n],
                               np.asarray(js.total_lq)[:n],
                               rtol=FLOAT_RTOL)


# ---- the kernel's strand entry (plain version) --------------------------

@pytest.mark.parametrize("k", [21, 32, 33, 55, 127])
def test_canonical_keys_match_jax(k):
    rng = np.random.default_rng(k)
    L = 150
    codes = rng.integers(0, 4, (12, L), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.02] = dna.INVALID_CODE
    lengths = np.full(12, L, np.int32)
    lengths[1], lengths[3], lengths[5] = L // 2, 3, k
    codes[np.arange(L)[None, :] >= lengths[:, None]] = dna.INVALID_CODE
    keys, valid, is_fwd = kmer_cuda.extract_canonical_keys(
        t(codes), t(lengths), k)
    canon, jvalid, jfwd = jkmer.extract_canonical_kmers(
        jnp.asarray(codes), jnp.asarray(lengths), k)
    W = dna.words_per_kmer(k)
    jwords = np.asarray(canon).reshape(-1, W)
    jvalid = np.asarray(jvalid).reshape(-1)
    words = u32(segments.unfuse_keys(list(keys.unbind(0)), W))
    # the strand is defined on every window, the invalid ones too
    assert np.array_equal(is_fwd.numpy(), np.asarray(jfwd).reshape(-1))
    if k % dna.BASES_PER_WORD:
        assert valid is None
        assert np.array_equal(~np.all(words == 0xFFFFFFFF, axis=1), jvalid)
        assert np.array_equal(words[jvalid], jwords[jvalid])
    else:
        assert np.array_equal(valid.numpy(), jvalid)
        assert np.array_equal(words, jwords)
    # the sort-key entry is the same keys
    sk, sv = kmer.extract_sort_keys(t(codes), t(lengths), k)
    assert torch.equal(sk, keys)
    assert (sv is None) == (valid is None)


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_search_keys_matches_jax_searchsorted_rows(W):
    rng = np.random.default_rng(W)
    hay = np.unique(rng.integers(0, 1 << 32, (300, W), dtype=np.int64),
                    axis=0)
    pad = np.full((20, W), dna.WORD_MASK, np.int64)
    table = np.concatenate([hay, pad])
    needles = np.concatenate([hay[rng.integers(0, len(hay), 200)],
                              rng.integers(0, 1 << 32, (100, W)),
                              pad[:3]])
    want = np.asarray(jseg.searchsorted_rows(
        jnp.asarray(table.astype(np.uint32)),
        jnp.asarray(needles.astype(np.uint32))))
    hay_keys = segments.fuse_words(t(table))  # fused once, searched twice
    got = segments.search_keys(hay_keys, segments.fuse_words(t(needles)))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(segments.searchsorted_rows(t(table), t(needles)), got)
    assert (got[:200] < len(hay)).all() and (got[200:300] == len(table)).any()
    # the all-ones needle meets the first padding row, past the rows the
    # callers count as found
    assert got[-1] == len(hay)
    assert torch.equal(
        segments.search_keys(segments.fuse_words(t(table)[:0]),
                             segments.fuse_words(t(needles))),
        torch.zeros(len(needles), dtype=torch.int64))


# ---- counting -----------------------------------------------------------

def test_count_kmers_quality_matches_jax(reads):
    codes, lengths, quals = reads
    table, qweight = counter.count_kmers_quality(t(codes), t(lengths),
                                                 t(quals), K)
    jt, jw = jcounter.count_kmers_quality(
        jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(quals), K)
    n = int(jt.num)
    assert int(table.num) == n
    assert np.array_equal(u32(table.kmers), np.asarray(jt.kmers))
    assert np.array_equal(table.counts.numpy(), np.asarray(jt.counts))
    np.testing.assert_allclose(qweight.numpy(), np.asarray(jw),
                               rtol=FLOAT_RTOL)
    # the rounded weights cluster: they must be equal
    assert np.array_equal(torch.round(qweight[:n]).numpy(),
                          np.round(np.asarray(jw)[:n]))


def test_count_kmers_stats_matches_jax(reads):
    codes, lengths, quals = reads
    table, stats = bayes._trim_stats(*bayes.count_kmers_stats(
        t(codes), t(lengths), t(quals), K))
    jt, js = jbayes._trim_stats(*jbayes.count_kmers_stats(
        jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(quals), K))
    assert_stats_match(jt, js, table, stats)


@pytest.mark.parametrize("chunk,cap", [(16, None), (16, 32)],
                         ids=["two_pass", "spill"])
def test_count_kmers_stats_chunked_matches_jax(chunk, cap):
    codes, lengths, quals = simulated(size=400, seed=11, read_len=60)
    codes, lengths, quals = codes[:64], lengths[:64], quals[:64]
    kw = {"chunk": chunk}
    if cap is not None:
        kw["device_cap_rows"] = cap
    table, stats = bayes.count_kmers_stats_chunked(
        t(codes), t(lengths), t(quals), K, **kw)
    jt, js = jbayes.count_kmers_stats_chunked(codes, lengths, quals, K, **kw)
    assert_stats_match(jt, js, table, stats)
    # every branch counts what the one-shot count does
    one, one_stats = bayes._trim_stats(*bayes.count_kmers_stats(
        t(codes), t(lengths), t(quals), K))
    n = int(one.num)
    assert torch.equal(table.kmers[:n], one.kmers[:n])
    assert torch.equal(stats.qual_sum[:n], one_stats.qual_sum[:n])


def test_chunk_sizes_on_the_cpu_and_explicit_ones_win():
    cpu = torch.device("cpu")
    assert bayes.stats_chunk_reads(100, K, cpu) == \
        bayes.CPU_STATS_CHUNK_READS
    assert bayes.table_cap_rows(K, cpu) == bayes.CPU_DEVICE_CAP_ROWS
    assert bayes.expand_chunk_reads(100, K, cpu) == \
        bayes.CPU_EXPAND_CHUNK_READS
    assert correct.vote_chunk_reads(100, K, cpu) == correct.CPU_CHUNK_READS
    assert bayes.SUBCLUSTER_CHUNK == 1 << 18  # part of the result


# ---- clustering and subclustering ---------------------------------------

@pytest.mark.parametrize("good,ratio", [(2 ** 30, 0.0), (5, 10.0)],
                         ids=["topology", "center_ratio"])
def test_cluster_kmers_matches_jax(counted, good, ratio):
    jt, _, table, _ = counted
    jcl = jcluster.cluster_kmers(jt.kmers, jt.counts, jt.num, K,
                                 jnp.int32(good), jnp.float32(ratio))
    cl = cluster.cluster_kmers(table.kmers, table.counts, table.num, K,
                               good, ratio)
    theirs = {f: np.asarray(getattr(jcl, f)) for f in jcl._fields}
    ours = interop.hammer_clusters_to_numpy(cl)
    for field in ("rep", "is_center", "solid", "center_of"):
        assert np.array_equal(ours[field], theirs[field]), field
    n = int(jt.num)
    assert len(np.unique(theirs["rep"][:n])) < n  # some clusters joined


def test_subcluster_kmers_matches_jax(counted, clustered):
    jt, js, table, stats = counted
    jcl, jsub = clustered
    sub = bayes.subcluster_kmers(table.kmers, table.counts, table.num,
                                 stats, t(np.asarray(jcl.rep)).long(), K)
    ours = interop.subclusters_to_numpy(sub)
    for field in jsub._fields:
        assert np.array_equal(ours[field], np.asarray(getattr(jsub, field))
                              ), field
    assert ours["solid"].sum() > 0


def test_subcluster_kmers_chunked_matches_jax(counted, clustered):
    jt, js, table, stats = counted
    jcl, _ = clustered
    chunk = 512
    assert table.capacity > chunk
    jsub = jbayes.subcluster_kmers_chunked(jt.kmers, jt.counts, jt.num, js,
                                           jcl.rep, K, chunk=chunk)
    sub = bayes.subcluster_kmers_chunked(
        table.kmers, table.counts, table.num, stats,
        t(np.asarray(jcl.rep)).long(), K, chunk=chunk)
    ours = interop.subclusters_to_numpy(sub)
    for field in jsub._fields:
        assert np.array_equal(ours[field], np.asarray(getattr(jsub, field))
                              ), field


# ---- expansion and voting -----------------------------------------------

@pytest.mark.parametrize("chunk_reads", [None, 37])
def test_expand_solid_matches_jax(reads, counted, clustered, chunk_reads):
    codes, lengths, _ = reads
    jt, _, table, _ = counted
    _, jsub = clustered
    # a sparse start, so that the rounds have work to do
    solid0 = np.asarray(jsub.solid) & (np.arange(jt.kmers.shape[0]) % 3 == 0)
    if chunk_reads is None:
        want = jbayes.expand_solid(jnp.asarray(codes), jnp.asarray(lengths),
                                   jt, jnp.asarray(solid0), K)
        got = bayes.expand_solid(t(codes), t(lengths), table, t(solid0), K)
    else:
        want = jbayes.expand_solid_chunked(codes, lengths, jt,
                                           jnp.asarray(solid0), K,
                                           chunk_reads=chunk_reads)
        got = bayes.expand_solid_chunked(t(codes), t(lengths), table,
                                         t(solid0), K,
                                         chunk_reads=chunk_reads)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > solid0.sum()


def test_correct_batch_matches_jax(reads):
    codes, lengths, _ = reads
    jt = jcounter.trim_table(jcounter.count_kmers(
        jnp.asarray(codes), jnp.asarray(lengths), K))
    jcl = jcluster.cluster_kmers(jt.kmers, jt.counts, jt.num, K,
                                 jnp.int32(6), jnp.float32(10.0))
    want = jcorrect.correct_batch(jnp.asarray(codes), jnp.asarray(lengths),
                                  jt, jcl, K)
    table = interop.kmer_table_from_numpy(jt.kmers, jt.counts, jt.num)
    cl = interop.hammer_clusters_from_numpy(*(np.asarray(x) for x in jcl))
    got = correct.correct_batch(t(codes), t(lengths), table, cl, K)
    assert np.array_equal(got.codes.numpy(), np.asarray(want.codes))
    assert int(got.changed_bases) == int(want.changed_bases) > 0
    assert int(got.solid_kmers) == int(want.solid_kmers)


def test_correct_batch_bayes_matches_jax(reads, counted, clustered):
    codes, lengths, _ = reads
    jt, _, table, _ = counted
    _, jsub = clustered
    want = jcorrect.correct_batch_bayes(
        jnp.asarray(codes), jnp.asarray(lengths), jt, jsub.solid,
        jsub.center_bases, K)
    sub = interop.subclusters_from_numpy(*(np.asarray(x) for x in jsub))
    got = correct.correct_batch_bayes(t(codes), t(lengths), table,
                                      sub.solid, sub.center_bases, K)
    assert np.array_equal(got.codes.numpy(), np.asarray(want.codes))
    assert int(got.changed_bases) == int(want.changed_bases) > 0
    assert int(got.solid_kmers) == int(want.solid_kmers)


# ---- the whole corrector ------------------------------------------------

@pytest.mark.parametrize("with_quals,bayes_mode", [
    (True, True), (True, False), (False, True)],
    ids=["bayes", "quality_weights", "no_qualities"])
def test_correct_reads_matches_jax(with_quals, bayes_mode):
    codes, lengths, quals = simulated(size=2500, seed=3, error_rate=0.005)
    q = quals if with_quals else None
    # the heuristic's iterations each fit the coverage model (seconds on
    # the CPU in both packages): one is enough to compare them
    iters = 2 if (with_quals and bayes_mode) else 1
    want, wstats = jcorrect.correct_reads(codes, lengths, k=K, quals=q,
                                          bayes=bayes_mode,
                                          max_iterations=iters)
    got, stats = correct.correct_reads(
        t(codes), t(lengths), k=K, quals=None if q is None else t(q),
        bayes=bayes_mode, device="cpu", chunk_reads=300,
        max_iterations=iters)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert stats == wstats
    assert stats["changed_bases"] > 0
    assert all(type(v) in (int, float, str) for v in stats.values())


def test_correct_reads_fixes_most_errors():
    size = 4000
    genome = simulate.random_genome(size, seed=21)
    sims = [simulate.simulate_paired_reads(
        genome, 400, read_len=100, error_rate=rate, seed=22)
        for rate in (0.004, 0.0)]   # the same draws, without errors
    codes, lengths = dna.encode_reads(sims[0][0] + sims[0][2])
    truth, _ = dna.encode_reads(sims[1][0] + sims[1][2])
    quals = np.frombuffer("".join(sims[0][1] + sims[0][3]).encode(),
                          np.uint8).reshape(codes.shape).copy()
    fixed, _ = correct.correct_reads(t(codes), t(lengths), quals=t(quals),
                                     device="cpu")
    wrong = codes != truth
    left = fixed.numpy() != truth
    assert wrong.sum() > 100
    assert left.sum() * 4 <= wrong.sum()
    assert not (left & ~wrong).any()


def test_correct_reads_runs_on_the_card_unless_asked(reads):
    if torch.cuda.is_available():
        pytest.skip("shows the refusal on a machine without a card")
    codes, lengths, quals = reads
    with pytest.raises(RuntimeError, match="CUDA card"):
        correct.correct_reads(t(codes), t(lengths), quals=t(quals))
    with pytest.raises(RuntimeError, match="CUDA card"):
        ionhammer.correct_reads_ion(t(codes), t(lengths))


# ---- IonHammer ----------------------------------------------------------

def ion_reads(seed=4, n=900, read_len=80):
    """Reads with homopolymer over- and under-calls, an N and padding."""
    genome = simulate.random_genome(5000, seed=seed)
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n):
        s = int(rng.integers(0, len(genome) - read_len))
        r = list(genome[s:s + read_len])
        p = int(rng.integers(1, read_len - 2))
        if rng.random() < 0.2:
            r.insert(p, r[p])
        elif rng.random() < 0.1 and r[p] == r[p + 1]:
            del r[p]
        reads.append("".join(r))
    codes, lengths = dna.encode_reads(reads)
    codes[5, 10] = dna.INVALID_CODE
    return codes, lengths


def test_hp_compress_and_decompress_match_jax():
    codes, lengths = ion_reads()
    jb, jr, jc = jion.hp_compress(codes, lengths)
    b, r, c = ionhammer.hp_compress(t(codes), t(lengths))
    assert np.array_equal(b.numpy(), jb)
    assert np.array_equal(r.numpy(), jr)
    assert np.array_equal(c.numpy(), jc)
    for width in (codes.shape[1], codes.shape[1] + 7):
        jcodes, jlens = jion.hp_decompress(jb, jr, jc, width)
        out, lens = ionhammer.hp_decompress(b, r, c, width)
        assert np.array_equal(out.numpy(), jcodes)
        assert np.array_equal(lens.numpy(), jlens)


def test_correct_reads_ion_matches_jax():
    codes, lengths = ion_reads()
    jcodes, jlens, jstats = jion.correct_reads_ion(codes, lengths)
    out, lens, stats = ionhammer.correct_reads_ion(t(codes), t(lengths),
                                                   device="cpu")
    assert np.array_equal(out.numpy(), jcodes)
    assert np.array_equal(lens.numpy(), jlens)
    assert stats == jstats and stats["changed_runs"] > 0


# ---- interop ------------------------------------------------------------

def test_hammer_state_round_trips_through_interop(counted, clustered):
    _, js, _, stats = counted
    jcl, jsub = clustered
    back = interop.qual_stats_to_numpy(stats)
    assert np.array_equal(back["total_lq"], np.asarray(js.total_lq))
    assert np.array_equal(back["qual_sum"], np.asarray(js.qual_sum))
    cl = interop.hammer_clusters_from_numpy(*(np.asarray(x) for x in jcl))
    assert cl.rep.dtype == torch.int64 and cl.center_of.dtype == torch.int64
    for name, value in interop.hammer_clusters_to_numpy(cl).items():
        want = np.asarray(getattr(jcl, name))
        assert value.dtype == want.dtype and np.array_equal(value, want)
    sub = interop.subclusters_from_numpy(*(np.asarray(x) for x in jsub))
    for name, value in interop.subclusters_to_numpy(sub).items():
        want = np.asarray(getattr(jsub, name))
        assert value.dtype == want.dtype and np.array_equal(value, want)


def test_hammer_never_calls_the_plain_extraction_on_its_own(reads,
                                                            monkeypatch):
    """The passes reach windows through the kernel's wrapper only: with
    the wrapper's CPU dispatch the one way to the plain version, a CUDA
    tensor cannot meet it."""
    calls = []
    real = kmer_cuda.extract_sort_keys.canonical_keys

    def counted_entry(codes, lengths, k):
        calls.append(codes.shape)
        return real(codes, lengths, k)
    monkeypatch.setattr(kmer_cuda, "extract_canonical_keys", counted_entry)
    codes, lengths, quals = reads
    correct.correct_reads(t(codes), t(lengths), quals=t(quals),
                          device="cpu", max_iterations=1)
    assert len(calls) >= 3  # statistics, expansion, voting
