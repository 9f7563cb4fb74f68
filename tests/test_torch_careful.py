"""Careful mode (mismatch correction) in the PyTorch port vs the JAX
package: the JAX tests' two anchors, the votes at two chunk sizes, and
``--careful`` through both command lines, single-end and paired."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import naive_debruijn as nd  # noqa: E402
from spades_for_blackbird_tpu import cli as jcli  # noqa: E402
from spades_for_blackbird_tpu.graph import construct as jconstruct  # noqa: E402
from spades_for_blackbird_tpu.pipeline import (  # noqa: E402
    mismatch_correction as jmc)
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import cli, interop  # noqa: E402
from spades_for_blackbird_tpu_torch.io.fasta import graph_contigs  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import (  # noqa: E402
    mismatch_correction)
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

K = 15
OUTPUTS = ("contigs.fasta", "scaffolds.fasta", "before_rr.fasta",
           "assembly_graph_with_scaffolds.gfa", "assembly_graph.fastg",
           "contigs.paths", "scaffolds.paths")


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


def tile(s, L=50, step=5):
    return [s[i:i + L] for i in range(0, len(s) - L + 1, step)] + \
        [s[len(s) - L:]]


def port_graph(jg):
    return interop.graph_from_numpy(
        interop.fields_of(jg, interop.GRAPH_FIELDS), jg.k)


def corrupted():
    """tests/test_gapclose_mismatch.py::test_mismatch_correction_fixes_
    consensus_error: one base mid-edge changed on the genome's edge and
    mirrored on its conjugate (two slots to fix). Returns (JAX graph,
    genome, codes, lengths)."""
    genome = random_dna(400, 2)
    codes, lengths = dna.encode_reads(tile(genome, L=60, step=3))
    g = jconstruct.graph_from_reads(codes, lengths, K)
    flat = np.asarray(g.seq_flat).copy()
    for e in np.nonzero(np.asarray(g.alive))[0]:
        s, ln = int(g.seq_start[e]), int(g.seq_len[e])
        if dna.decode_codes(flat[s:s + ln]) == genome:
            break
    pos = s + 200
    flat[pos] = (flat[pos] + 1) % 4
    cs = int(g.seq_start[int(np.asarray(g.conj)[e])])
    flat[cs + (ln - 1 - 200)] = 3 - int(flat[pos])
    return g._replace(seq_flat=jnp.asarray(flat)), genome, codes, lengths


def clean():
    """::test_mismatch_correction_noop_on_clean_graph."""
    genome = random_dna(300, 3)
    codes, lengths = dna.encode_reads(tile(genome, L=50, step=5))
    return (jconstruct.graph_from_reads(codes, lengths, K), genome, codes,
            lengths)


@pytest.mark.parametrize("fixture,fixed", [(corrupted, 2), (clean, 0)])
def test_correct_mismatches_matches_jax(fixture, fixed):
    jg, genome, codes, lengths = fixture()
    g, n = mismatch_correction.correct_mismatches(
        port_graph(jg), codes, lengths, device="cpu")
    jg2, jn = jmc.correct_mismatches(jg, codes, lengths)
    assert n == jn == fixed
    assert np.array_equal(g.seq_flat.numpy(), np.asarray(jg2.seq_flat))
    seqs = {s for s, _ in graph_contigs(g)}
    assert genome in seqs or nd.rc(genome) in seqs


def test_votes_do_not_depend_on_the_chunk():
    jg, _, codes, lengths = corrupted()
    g = port_graph(jg)
    whole, n = mismatch_correction.correct_mismatches(g, codes, lengths,
                                                      device="cpu")
    chunked, n7 = mismatch_correction.correct_mismatches(
        g, codes, lengths, chunk=7, device="cpu")
    assert n == n7 == 2
    assert torch.equal(whole.seq_flat, chunked.seq_flat)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    root = tmp_path_factory.mktemp("careful")
    genome = simulate.random_genome(5000, seed=71, repeats=[(300, 2)])
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, 750, read_len=100, insert_mean=300, insert_sd=25,
        error_rate=0.002, seed=72)
    paths = (str(root / "r_1.fq"), str(root / "r_2.fq"))
    simulate.write_fastq(paths[0], r1, q1)
    simulate.write_fastq(paths[1], r2, q2)
    return paths


@pytest.mark.parametrize("paired", [False, True])
def test_careful_command_line_matches_jax(reads, tmp_path, paired):
    inputs = ["-1", reads[0], "-2", reads[1]] if paired else ["-s", reads[0]]
    argv = inputs + ["-k", "33", "--careful", "--only-assembler",
                     "--checkpoints", "none"]
    assert cli.main(argv + ["-o", str(tmp_path / "port"), "--device",
                            "cpu"]) == 0
    try:
        assert jcli.main(argv + ["-o", str(tmp_path / "jax")]) == 0
    finally:
        jlogger.configure()
    for name in OUTPUTS[:5] + (OUTPUTS[5:] if paired else ()):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    log = (tmp_path / "port" / "spades.log").read_text()
    assert "== STAGE mismatch_correction" in log
    assert "mismatching bases" in log
