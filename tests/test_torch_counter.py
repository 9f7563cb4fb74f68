"""PyTorch port vs the JAX package: k-mer counting and the coverage
spectrum. Counted tables must be bit-equal."""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: more intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from spades_for_blackbird_tpu.kmers import counter as jcounter  # noqa: E402
from spades_for_blackbird_tpu.kmers import coverage_model as jcov  # noqa: E402
from spades_for_blackbird_tpu_torch import interop  # noqa: E402
from spades_for_blackbird_tpu_torch.kmers import counter  # noqa: E402
from spades_for_blackbird_tpu_torch.kmers import coverage_model  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import (  # noqa: E402
    dna, kmer, segments)
from spades_for_blackbird_tpu_torch.utils import (  # noqa: E402
    simulate, timetrace)

COUNT_KS = [22, 34, 56, 78, 128]  # (k+1)-mer sizes of the K ladders


def sim_reads(seed, genome_len=3000, n_pairs=150, L=150):
    genome = simulate.random_genome(genome_len, seed=seed)
    r1, _, r2, _ = simulate.simulate_paired_reads(
        genome, n_pairs, read_len=L, insert_mean=400, insert_sd=20,
        error_rate=0.01, seed=seed + 1)
    codes, lengths = dna.encode_reads(r1 + r2)
    rng = np.random.default_rng(seed)
    codes[rng.random(codes.shape) < 0.003] = dna.INVALID_CODE  # N bases
    short = rng.random(len(lengths)) < 0.1
    lengths[short] = rng.integers(10, L, short.sum())
    codes[np.arange(L)[None, :] >= lengths[:, None]] = dna.INVALID_CODE
    return codes, lengths


def assert_tables_equal(t, jt, same_capacity=True):
    a = interop.kmer_table_to_numpy(t)
    n = int(jt.num)
    assert a["num"] == n
    if same_capacity:
        assert t.capacity == jt.capacity
    assert np.array_equal(a["kmers"][:n], np.asarray(jt.kmers)[:n])
    assert np.array_equal(a["counts"][:n], np.asarray(jt.counts)[:n])
    # padding rows are the all-ones sentinel in both
    assert (a["kmers"][n:] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("k", COUNT_KS)
def test_count_kmers_matches_jax(k):
    codes, lengths = sim_reads(k)
    t = counter.count_kmers(torch.from_numpy(codes),
                            torch.from_numpy(lengths), k)
    jt = jcounter.count_kmers(jnp.asarray(codes), jnp.asarray(lengths), k)
    assert_tables_equal(t, jt)


@pytest.mark.parametrize("k", [56, 128])
def test_count_kmers_sorts_the_extraction_keys_as_they_are(k, monkeypatch):
    """Nothing stands between the extraction and the sort: the counter
    hands ``count_sorted_keys`` the very columns ``extract_sort_keys``
    wrote, with the validity column only where k % 16 == 0."""
    codes, lengths = sim_reads(k + 5, genome_len=1000, n_pairs=40)
    codes, lengths = torch.from_numpy(codes), torch.from_numpy(lengths)
    seen = {}
    real = segments.count_sorted_keys

    def spy(keys, n_words, valid=None):
        seen["keys"], seen["n_words"], seen["valid"] = keys, n_words, valid
        return real(keys, n_words, valid)

    monkeypatch.setattr(segments, "count_sorted_keys", spy)
    t = counter.count_kmers(codes, lengths, k)
    ref_keys, ref_valid = kmer.extract_sort_keys(codes, lengths, k)
    assert seen["n_words"] == dna.words_per_kmer(k)
    assert torch.equal(torch.stack(list(seen["keys"])), ref_keys)
    assert (seen["valid"] is None) == (k % 16 != 0)
    if ref_valid is not None:
        assert torch.equal(seen["valid"], ref_valid)
    jt = jcounter.count_kmers(jnp.asarray(codes.numpy()),
                              jnp.asarray(lengths.numpy()), k)
    assert_tables_equal(t, jt)


@pytest.mark.parametrize("k", [22, 56])
def test_count_kmers_chunked_and_merge_match_jax(k):
    codes, lengths = sim_reads(k + 100)
    t = counter.count_kmers_chunked(torch.from_numpy(codes),
                                    torch.from_numpy(lengths), k,
                                    chunk_reads=64)
    jt = jcounter.count_kmers_chunked(codes, lengths, k, chunk_reads=64)
    assert_tables_equal(t, jt)
    whole = counter.count_kmers(torch.from_numpy(codes),
                                torch.from_numpy(lengths), k)
    assert_tables_equal(whole, jt, same_capacity=False)


@pytest.mark.parametrize("min_count", [2, 3])
def test_filter_trim_lookup_match_jax(min_count):
    codes, lengths = sim_reads(7)
    k = 22
    t = counter.count_kmers(torch.from_numpy(codes),
                            torch.from_numpy(lengths), k)
    jt = jcounter.count_kmers(jnp.asarray(codes), jnp.asarray(lengths), k)
    f = counter.trim_table(counter.filter_min_count(t, min_count))
    jf = jcounter.trim_table(jcounter.filter_min_count(jt, min_count))
    assert_tables_equal(f, jf)
    queries = np.asarray(jt.kmers)[:int(jt.num)][::3]
    idx, found = counter.lookup(f, torch.from_numpy(queries.astype(np.int64)))
    jidx, jfound = jcounter.lookup(jf, jnp.asarray(queries))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(found.numpy(), np.asarray(jfound))


def test_count_matches_naive_counter():
    rng = np.random.default_rng(0)
    seqs = ["".join(rng.choice(list("ACGTN"), p=[.24, .24, .24, .24, .04],
                               size=int(n)))
            for n in rng.integers(15, 80, 40)]
    codes, lengths = dna.encode_reads(seqs)
    k = 22
    t = interop.kmer_table_to_numpy(counter.count_kmers(
        torch.from_numpy(codes), torch.from_numpy(lengths), k))
    naive = collections.Counter()
    for s in seqs:
        for i in range(len(s) - k + 1):
            km = s[i:i + k]
            if "N" not in km:
                naive[min(km, dna.revcomp_str(km))] += 1
    words = dna.pack_kmers(torch.from_numpy(np.stack(
        [dna.encode_str(s) for s in sorted(naive)])), k).numpy()
    assert t["num"] == len(naive)
    assert np.array_equal(t["kmers"][:t["num"]], words.astype(np.uint32))
    assert list(t["counts"][:t["num"]]) == [naive[s] for s in sorted(naive)]


def test_count_spectrum_matches_jax():
    codes, lengths = sim_reads(3, genome_len=2000, n_pairs=400, L=100)
    k = 22
    t = counter.count_kmers(torch.from_numpy(codes),
                            torch.from_numpy(lengths), k)
    jt = jcounter.count_kmers(jnp.asarray(codes), jnp.asarray(lengths), k)
    h = coverage_model.count_spectrum_device(t.counts, t.num)
    jh = jcov.count_spectrum_device(jt.counts, jt.num)
    assert np.array_equal(h, jh)
    # with the time trace on, the fit counts its likelihood evaluations
    # and the path that answered, and gives the reference's answer
    timetrace.enable()
    try:
        fitted = coverage_model.fit_coverage_model_hist(h)
    finally:
        timetrace.disable()
    assert vars(fitted) == vars(jcov.fit_coverage_model_hist(jh))
    counts = timetrace.counters()
    assert counts["fit_evaluations"] > 0 and counts["fit_rounds"] > 0
    assert [n for n in counts if n.startswith("fit_path.")] in (
        ["fit_path.reference"], ["fit_path.mixture"], ["fit_path.valley"])


def test_chunk_size_on_cpu_is_the_fixed_default():
    assert counter.chunk_reads_for(100, 56, torch.device("cpu")) == \
        counter.CPU_CHUNK_READS
