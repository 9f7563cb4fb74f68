"""The blackbird fork's restricted edges in the PyTorch port vs the JAX
package: the mask of ``fill_restricted_edges``, the bulge passes with and
without it, and ``assemble_single_k(restricted_sequences=...)`` keeping a
weak allele only when it is restricted."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from spades_for_blackbird_tpu.graph import construct as jconstruct  # noqa: E402
from spades_for_blackbird_tpu.models import bio as jbio  # noqa: E402
from spades_for_blackbird_tpu.pipeline import assemble as jassemble  # noqa: E402
from spades_for_blackbird_tpu.simplify import advanced as jadv  # noqa: E402
from spades_for_blackbird_tpu.simplify import passes as jpasses  # noqa: E402
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import interop  # noqa: E402
from spades_for_blackbird_tpu_torch.graph.graph import edge_mask  # noqa: E402
from spades_for_blackbird_tpu_torch.models import bio  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import assemble  # noqa: E402
from spades_for_blackbird_tpu_torch.simplify import advanced, passes  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

K = 15


@pytest.fixture(autouse=True)
def _reference_logger_reset(monkeypatch):
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    jlogger.configure()


def random_dna(n, seed):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), size=n))


def tile(s, L=50, step=5):
    return [s[i:i + L] for i in range(0, len(s) - L + 1, step)] + \
        [s[len(s) - L:]]


@pytest.fixture(scope="module")
def bulge():
    """tests/test_bio_hmm.py:110-136: stem -> {strong variant, weak
    variant} -> stem, and a sequence through the weak one. Returns (JAX
    graph, port graph, v_space, restricted sequences)."""
    pre, post = random_dna(100, 6), random_dna(100, 7)
    mid_a = random_dna(30, 8)
    mid_b = mid_a[:15] + ("A" if mid_a[15] != "A" else "C") + mid_a[16:]
    reads = tile(pre + mid_a + post) * 6 + tile(pre + mid_b + post) * 2
    codes, lengths = dna.encode_reads(reads)
    jg = jconstruct.graph_from_reads(codes, lengths, K)
    g = interop.graph_from_numpy(
        interop.fields_of(jg, interop.GRAPH_FIELDS), jg.k)
    return jg, g, 4 * jg.capacity, [pre[-20:] + mid_b + post[:20]]


def alive(g):
    return np.asarray(edge_mask(g) if isinstance(g.alive, torch.Tensor)
                      else jpasses.edge_mask(g))


def test_fill_restricted_edges_matches_jax(bulge):
    jg, g, _, seqs = bulge
    mask = bio.fill_restricted_edges(g, seqs)
    jmask = jbio.fill_restricted_edges(jg, seqs)
    assert np.array_equal(mask.numpy(), jmask)
    assert mask.sum() >= 2
    # a sequence no longer than k marks nothing
    assert not bio.fill_restricted_edges(g, ["ACGT" * 3]).any()


@pytest.mark.parametrize("protect", [False, True])
def test_remove_bulges_protected_matches_jax(bulge, protect):
    jg, g, v_space, seqs = bulge
    mask = bio.fill_restricted_edges(g, seqs) if protect else None
    jmask = (jnp.asarray(jbio.fill_restricted_edges(jg, seqs)) if protect
             else None)
    out = passes.remove_bulges(g, v_space, 3 * K, 0.1, 1000.0,
                               protected=mask)
    jout = jpasses.remove_bulges(jg, v_space, jnp.int32(3 * K),
                                 jnp.float32(0.1), jnp.float32(1000.0),
                                 protected=jmask)
    assert np.array_equal(alive(out), alive(jout))
    np.testing.assert_allclose(out.cov.numpy(), np.asarray(jout.cov),
                               rtol=1e-5)
    # the weak variant is glued away unless it is protected
    assert (alive(out).sum() == alive(jg).sum()) == protect


@pytest.mark.parametrize("protect", [False, True])
def test_remove_path_bulges_protected_matches_jax(bulge, protect):
    jg, g, v_space, seqs = bulge
    mask = (bio.fill_restricted_edges(g, seqs).numpy() if protect
            else None)
    out, vs, n = advanced.remove_path_bulges(g, v_space, max_length=3 * K,
                                             protected=mask)
    jout, jvs, jn = jadv.remove_path_bulges(jg, v_space, max_length=3 * K,
                                            protected=mask)
    assert (vs, n) == (jvs, jn)
    assert n == (0 if protect else 1)
    assert np.array_equal(alive(out), alive(jout))
    np.testing.assert_allclose(out.cov.numpy(), np.asarray(jout.cov),
                               rtol=1e-5)


def _allele_reads():
    """A 10 kb genome at 30x and a copy of 2 kb of it with four SNPs 400
    bases apart at 15x (a heterozygous allele). Returns (codes, lengths,
    the 2k+1 = 43-base windows centred on the variant SNPs)."""
    genome = simulate.random_genome(10_000, seed=91)
    variant = list(genome[4000:6000])
    snps = (400, 800, 1200, 1600)
    for p in snps:
        variant[p] = "ACGT"[("ACGT".index(variant[p]) + 1) % 4]
    variant = "".join(variant)
    r1, _, r2, _ = simulate.simulate_paired_reads(
        genome, 1500, read_len=100, insert_mean=300, insert_sd=25,
        error_rate=0.001, seed=92)
    v1, _, v2, _ = simulate.simulate_paired_reads(
        variant, 150, read_len=100, insert_mean=300, insert_sd=25,
        error_rate=0.001, seed=93)
    codes, lengths = dna.encode_reads(r1 + r2 + v1 + v2)
    return codes, lengths, [variant[p - 21:p + 22] for p in snps]


def test_assemble_single_k_restricted_matches_jax():
    codes, lengths, windows = _allele_reads()
    kept = {}
    for restricted in (None, windows):
        res = assemble.assemble_single_k(
            codes, lengths, 21, restricted_sequences=restricted,
            device="cpu")
        jres = jassemble.assemble_single_k(
            jnp.asarray(codes), jnp.asarray(lengths), 21,
            restricted_sequences=restricted)
        a, b = ([(min(s, dna.revcomp_str(s)), c) for s, c in r.contigs]
                for r in (res, jres))
        a, b = sorted(a), sorted(b)
        assert [s for s, _ in a] == [s for s, _ in b]
        np.testing.assert_allclose([c for _, c in a], [c for _, c in b],
                                   rtol=1e-4)
        seqs = [s for s, _ in res.contigs]
        kept[restricted is not None] = sum(
            any(w in s or dna.revcomp_str(w) in s for s in seqs)
            for w in windows)
    assert kept == {False: 0, True: len(windows)}
