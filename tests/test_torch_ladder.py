"""The PyTorch port's K ladder vs the JAX package: contig windows, extra
sequences in construction, the pre-simplify checkpoint, and
``assemble_multi_k`` rung by rung."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: more intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from spades_for_blackbird_tpu.graph.graph import Graph as JGraph  # noqa: E402
from spades_for_blackbird_tpu.kmers import counter as jcounter  # noqa: E402
from spades_for_blackbird_tpu.kmers import (  # noqa: E402
    coverage_model as jcm)
from spades_for_blackbird_tpu.pipeline import (  # noqa: E402
    assemble as jassemble)
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import interop  # noqa: E402
from spades_for_blackbird_tpu_torch.kmers import counter  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import assemble  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import assess, simulate  # noqa: E402

# Contig coverages are float32 averages summed in another order than
# XLA's; sequences must be identical.
COV_RTOL = 1e-4
WIDTH = 100
KS = [21, 33]


@pytest.fixture(autouse=True)
def _single_device_reference(monkeypatch):
    """The JAX package takes its single-device branch (the one the port
    mirrors) and logs through its default configuration."""
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    jlogger.configure()


@pytest.fixture(scope="module")
def _single_device_module():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
        yield


def canonical(contigs):
    return sorted((min(s, dna.revcomp_str(s)), c) for s, c in contigs)


def assert_same_contigs(ours, theirs):
    a, b = canonical(ours), canonical(theirs)
    assert [s for s, _ in a] == [s for s, _ in b]
    np.testing.assert_allclose([c for _, c in a], [c for _, c in b],
                               rtol=COV_RTOL)


def _table(t):
    d = interop.kmer_table_to_numpy(t)
    return d["kmers"][:d["num"]], d["counts"][:d["num"]]


def _jax_table(t):
    n = int(t.num)
    return np.asarray(t.kmers)[:n], np.asarray(t.counts)[:n]


def _count(codes, lengths, k):
    return counter.count_kmers_chunked(torch.from_numpy(codes),
                                       torch.from_numpy(lengths), k)


def _sequences(kp1):
    """Short, exactly one window, one base more, long with a ragged tail,
    long ending on a full window; some with an N."""
    rng = np.random.default_rng(kp1)

    def seq(n):
        return "".join(rng.choice(list("ACGT"), size=n))
    stride = WIDTH - kp1 + 1
    seqs = [seq(kp1), seq(kp1 + 7), seq(WIDTH), seq(WIDTH + 1),
            seq(5 * WIDTH + 13), seq(WIDTH + 3 * stride), seq(1234)]
    seqs[4] = seqs[4][:222] + "N" + seqs[4][223:]
    return seqs


@pytest.mark.parametrize("kp1", [22, 34, 56])
def test_windows_count_like_the_reference_and_like_whole_sequences(kp1):
    seqs = _sequences(kp1)
    ec, el = assemble._windows_from_sequences(seqs, WIDTH, kp1)
    assert ec.shape[1] == WIDTH and ec.dtype == np.uint8
    assert el.dtype == np.int32 and el.min() >= kp1
    ours = _table(_count(ec, el, kp1))
    # the JAX package pads the rows to a power of two; empty rows give no
    # k-mers, so the counted table is the same
    jc, jl = jassemble._windows_from_sequences(seqs, WIDTH, kp1)
    assert jc.shape[0] >= ec.shape[0]
    theirs = _jax_table(jcounter.count_kmers_chunked(
        jnp.asarray(jc), jnp.asarray(jl), kp1))
    assert np.array_equal(ours[0], theirs[0])
    assert np.array_equal(ours[1], theirs[1])
    # every k-mer of every sequence lies in exactly one window
    whole = _table(_count(*dna.encode_reads(seqs), kp1))
    assert np.array_equal(ours[0], whole[0])
    assert np.array_equal(ours[1], whole[1])


def test_windows_of_short_sequences_keep_their_own_width():
    ec, el = assemble._windows_from_sequences(["ACGT" * 10, "ACGTA" * 6],
                                              WIDTH, 22)
    assert ec.shape == (2, 40) and list(el) == [40, 30]


def _genome_reads(seed=11, size=6000):
    genome = simulate.random_genome(size, seed=seed, repeats=[(300, 2)])
    r1, _, r2, _ = simulate.simulate_paired_reads(
        genome, int(30 * size / 120), read_len=60, insert_mean=200,
        insert_sd=15, error_rate=0.003, seed=seed + 1)
    codes, lengths = dna.encode_reads(r1 + r2)
    return genome, codes, lengths


@pytest.fixture(scope="module")
def ladders(_single_device_module):
    """Both packages climb [21, 33] on the same reads, each rung fed its
    own package's contigs of the rung before: {k: (port, jax) results}."""
    genome, codes, lengths = _genome_reads()
    out, prev, jprev = {}, [], []
    for k in KS:
        res = assemble.assemble_single_k(codes, lengths, k, device="cpu",
                                         extra_sequences=prev)
        jres = jassemble.assemble_single_k(codes, lengths, k,
                                           extra_sequences=jprev)
        out[k] = (res, jres)
        prev = [s for s, _ in res.contigs]
        jprev = [s for s, _ in jres.contigs]
    return genome, codes, lengths, out


@pytest.mark.parametrize("k", KS)
def test_each_rung_matches_the_reference(ladders, k):
    _, _, _, out = ladders
    res, jres = out[k]
    assert_same_contigs(res.contigs, jres.contigs)
    assert vars(res.genomic_info) == vars(jres.genomic_info)
    assert res.stats["edges"] == jres.stats["edges"]


def test_extra_sequences_change_the_construction(ladders):
    """The second rung was built with the first rung's contigs; without
    them the graph differs (here: the extras close what the reads' 34-mers
    alone leave open), and the model is fitted on the reads alone."""
    _, codes, lengths, out = ladders
    with_extras, _ = out[33]
    alone = assemble.assemble_single_k(codes, lengths, 33, device="cpu")
    assert vars(alone.genomic_info) == vars(with_extras.genomic_info)
    assert alone.stats != with_extras.stats


def test_multi_k_matches_its_rungs_and_the_reference(ladders):
    genome, codes, lengths, out = ladders
    res = assemble.assemble_multi_k(codes, lengths, KS, device="cpu")
    # the fixture's loop is the JAX package's assemble_multi_k by hand
    last, jres = out[KS[-1]]
    assert res.contigs == last.contigs
    assert_same_contigs(res.contigs, jres.contigs)
    assert vars(res.genomic_info) == vars(jres.genomic_info)
    assert res.graph.k == KS[-1]
    report = assess.assess([s for s, _ in res.contigs], genome)
    assert report.misassemblies == 0 and report.genome_fraction > 0.9


def test_default_ladder_follows_the_read_length():
    for rl in (60, 100, 149, 150, 249, 250, 300):
        assert assemble.default_k_ladder(rl) == jassemble.default_k_ladder(rl)
    assert assemble.K_MERS_250[-1] == 127


def test_cov_cutoff_filters_after_the_extras_are_merged(ladders):
    """A (k+1)-mer seen once in the reads and once in the extras has
    count 2 at the filter, and stays."""
    _, codes, lengths, out = ladders
    extras = [s for s, _ in out[21][0].contigs]
    res = assemble.assemble_single_k(codes, lengths, 33, device="cpu",
                                     extra_sequences=extras,
                                     min_kmer_count=2)
    jres = jassemble.assemble_single_k(codes, lengths, 33,
                                       extra_sequences=extras,
                                       min_kmer_count=2)
    assert_same_contigs(res.contigs, jres.contigs)
    assert res.stats["edges"] == jres.stats["edges"]


def test_phase_checkpoint_is_shared_with_the_reference(tmp_path):
    """The pre-simplify save: written before simplification, removed by
    the finished stage, resumed from by either package."""
    _, codes, lengths = _genome_reads(seed=8, size=2000)
    k = 21
    res = assemble.assemble_single_k(codes, lengths, k, device="cpu",
                                     phase_dir=str(tmp_path / "run"))
    assert not (tmp_path / "run" / f"pre_simplify_k{k}.npz").exists()

    # a save of the port, as a stage leaves it when it dies in simplify
    t = torch.from_numpy
    g, v_space, ginfo = assemble._construct(
        t(codes), t(lengths), k, 1, None, True, torch.device("cpu"))
    ours = tmp_path / "ours"
    assemble._save_phase_presimplify(str(ours), k, g, v_space, ginfo)
    with np.load(ours / f"pre_simplify_k{k}.npz") as data:
        dtypes = {name: data[name].dtype for name in data.files}
    assert dtypes["seq_start"] == np.int32 and dtypes["conj"] == np.int32
    assert dtypes["num_edges"] == np.int32 and dtypes["cov"] == np.float32
    assert dtypes["seq_flat"] == np.uint8 and dtypes["alive"] == np.bool_
    assert dtypes["v_space"] == np.int64 and dtypes["ginfo_json"] == np.uint8

    # both packages resume from it (no reads are counted: none are given
    # that could be) and finish with the uninterrupted run's contigs
    none, no_len = np.zeros((0, 60), np.uint8), np.zeros(0, np.int32)
    jres = jassemble.assemble_single_k(none, no_len, k,
                                       phase_dir=str(ours))
    assert_same_contigs(res.contigs, jres.contigs)
    assemble._save_phase_presimplify(str(ours), k, g, v_space, ginfo)
    again = assemble.assemble_single_k(none, no_len, k, device="cpu",
                                       phase_dir=str(ours))
    assert again.contigs == res.contigs
    assert not (ours / f"pre_simplify_k{k}.npz").exists()

    # and the port resumes from a save the JAX package wrote
    theirs = tmp_path / "theirs"
    jassemble._save_phase_presimplify(
        str(theirs), k, _jax_graph(interop.graph_to_saved_arrays(g), k),
        v_space, jcm.GenomicInfo(**vars(ginfo)))
    back = assemble.assemble_single_k(none, no_len, k, device="cpu",
                                      phase_dir=str(theirs))
    assert back.contigs == res.contigs


def _jax_graph(arrays, k):
    return JGraph(**{name: jnp.asarray(arrays[name])
                     for name in interop.GRAPH_FIELDS if name in arrays},
                  k=k)
