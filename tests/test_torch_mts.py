"""The PyTorch port's series analysis vs the JAX package's: multi-sample
k-mer multiplicity profiles, contig and fragment abundance, the profile
``.npz`` read by either package, and ``--series-analysis`` through both
command lines.

Inputs are made from numpy seeds; every result must be identical, the
command lines' files byte for byte.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))

import test_mts_series as jfix  # noqa: E402
from spades_for_blackbird_tpu import cli as jcli  # noqa: E402
from spades_for_blackbird_tpu.mts import abundance as jabundance  # noqa: E402
from spades_for_blackbird_tpu.ops import dna as jdna  # noqa: E402
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import cli  # noqa: E402
from spades_for_blackbird_tpu_torch.mts import abundance  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

CPU = ["--device", "cpu"]
OUTPUTS = ("contigs.fasta", "scaffolds.fasta", "before_rr.fasta",
           "assembly_graph_with_scaffolds.gfa", "assembly_graph.fastg",
           "contigs.paths", "scaffolds.paths", "final.lib_data")
SERIES_OUTPUTS = ("edges.fasta", "edges.mpl", "frags.mpl")


@pytest.fixture(autouse=True)
def _reference_logger_reset(monkeypatch):
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    jlogger.configure()
    yield
    # the JAX command line leaves a writer on its closed log file
    jlogger.configure()


def _samples():
    """Two genomes in three samples at other depths, one read with an
    N."""
    a = jfix.random_dna(300, 3)
    b = jfix.random_dna(200, 2)
    s1 = jfix.tile(a) * 4
    s2 = jfix.tile(a) + jfix.tile(b) * 3
    s3 = jfix.tile(b) + [a[:40] + "N" + a[41:90]]
    return a, b, [jdna.encode_reads(s) for s in (s1, s2, s3)]


@pytest.mark.parametrize("k", [15, 16, 21, 33])
def test_profiles_and_abundance_match_jax(k):
    """Profiles (k = 16 holds a k-mer in one word exactly), contig and
    fragment abundance, and the k-mer rows of each contig, with contigs
    that hold an N, are shorter than k, or span both genomes."""
    a, b, batches = _samples()
    want = jabundance.multiplicity_profiles(batches, k)
    got = abundance.multiplicity_profiles(batches, k, device="cpu")
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    kmers, mult = got
    seqs = [a, b, a[:50] + "N" + a[60:200], "ACG", a + b]
    for x, y in zip(abundance._contig_kmer_rows(seqs, kmers, k,
                                                device="cpu"),
                    jabundance._contig_kmer_rows(seqs, kmers, k)):
        assert np.array_equal(x, y)
    for stat in ("median", "mean"):
        assert np.array_equal(
            abundance.contig_abundance(seqs, kmers, mult, k, stat=stat,
                                       device="cpu"),
            jabundance.contig_abundance(seqs, kmers, mult, k, stat=stat))
    for frag in (60, 100, 1000):
        assert np.array_equal(
            abundance.fragment_abundance(a + b, kmers, mult, k, frag,
                                         device="cpu"),
            jabundance.fragment_abundance(a + b, kmers, mult, k, frag))


def test_min_mult_and_depth_ratios():
    a, b, batches = _samples()
    kmers, mult = abundance.multiplicity_profiles(batches, 21, min_mult=5,
                                                  device="cpu")
    jk, jm = jabundance.multiplicity_profiles(batches, 21, min_mult=5)
    assert np.array_equal(kmers, jk) and np.array_equal(mult, jm)
    assert (mult.sum(axis=1) >= 5).all()
    prof = abundance.contig_abundance([a, b], *abundance.multiplicity_profiles(
        batches, 21, device="cpu"), 21, device="cpu")
    assert prof[0, 0] > 3 * prof[0, 1] and prof[0, 2] == 0
    assert prof[1, 0] == 0 and prof[1, 1] > 2 * prof[1, 2]


def test_profile_files_cross_packages(tmp_path):
    """A profile written by either package is read by the other."""
    _, _, batches = _samples()
    kmers, mult = abundance.multiplicity_profiles(batches, 21, device="cpu")
    abundance.save_profiles(str(tmp_path / "port.npz"), kmers, mult, 21)
    jabundance.save_profiles(str(tmp_path / "jax.npz"),
                             *jabundance.multiplicity_profiles(batches, 21),
                             21)
    for reader, writer in ((jabundance, "port"), (abundance, "jax")):
        k2, m2, k = reader.load_profiles(str(tmp_path / f"{writer}.npz"))
        assert k == 21 and k2.dtype == np.uint32 and m2.dtype == np.int32
        assert np.array_equal(k2, kmers) and np.array_equal(m2, mult)


@pytest.fixture(scope="module")
def series_inputs(tmp_path_factory):
    """FR pairs (100 bp, insert 300, 40x) of a 6 kb genome with a 400 bp
    repeat, a two-sample profile (the reads, and a third of the pairs)
    written by the port, and a series configuration for each package."""
    root = tmp_path_factory.mktemp("series")
    genome = simulate.random_genome(6000, seed=44, repeats=[(400, 2)])
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, 1200, read_len=100, insert_mean=300, insert_sd=20,
        error_rate=0.002, seed=45)
    paths = [str(root / f"s_{m}.fq") for m in (1, 2)]
    simulate.write_fastq(paths[0], r1, q1)
    simulate.write_fastq(paths[1], r2, q2)
    kmers, mult = abundance.multiplicity_profiles(
        [dna.encode_reads(r1 + r2), dna.encode_reads(r1[::3] + r2[::3])], 21,
        device="cpu")
    abundance.save_profiles(str(root / "prof.npz"), kmers, mult, 21)
    for tag in ("port", "jax"):
        (root / f"{tag}.yaml").write_text(
            f"k: 21\nsample_cnt: 2\nkmer_mult: {root}/prof.npz\n"
            f"min_len: 0  # every edge\nfrag_size: 150\n"
            + "".join(f'{key}: "{root}/{tag}_{name}"\n' for key, name in (
                ("edges_sqn", "edges.fasta"), ("edges_mpl", "edges.mpl"),
                ("edge_fragments_mpl", "frags.mpl"))))
    return root, paths


def test_series_command_line_matches_jax(series_inputs):
    root, (p1, p2) = series_inputs
    argv = ["-1", p1, "-2", p2, "-k", "21", "--only-assembler",
            "--checkpoints", "none"]
    assert cli.main(argv + ["--series-analysis", str(root / "port.yaml"),
                            "-o", str(root / "port")] + CPU) == 0
    try:
        assert jcli.main(argv + ["--series-analysis", str(root / "jax.yaml"),
                                 "-o", str(root / "jax")]) == 0
    finally:
        jlogger.configure()
    for name in OUTPUTS:
        assert (root / "port" / name).read_bytes() == \
            (root / "jax" / name).read_bytes(), name
    for name in SERIES_OUTPUTS:
        assert (root / f"port_{name}").read_bytes() == \
            (root / f"jax_{name}").read_bytes(), name
    rows = (root / "port_edges.mpl").read_text().splitlines()
    assert len(rows) > 1
    # the second sample holds a third of the pairs
    ratios = [float(r.split("\t")[1]) / float(r.split("\t")[2])
              for r in rows if float(r.split("\t")[2]) > 0]
    assert 2.5 < float(np.median(ratios)) < 3.5
    log = (root / "port" / "spades.log").read_text()
    assert f"series analysis: profiled {len(rows)} edges over 2 samples" \
        in log
