"""The PyTorch port's HLL estimator, edge positions and mts binning vs the
JAX package's: ``kmers/hll.py`` (the hash, the register rank on all 2^20
values of the rank bits, the registers and the estimate), ``graph/
positions.py``, ``mts/binning.py`` and the tools on top of them
(``kmer-estimating`` is in tests/test_torch_tools.py; ``prop-binning``,
``kmer-multiplicity-counter`` and ``contig-abundance`` here, on the
inputs of ``tests/test_mts_series.py:76-160``). Every result exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import naive_debruijn as nd  # noqa: E402
from spades_for_blackbird_tpu.graph import positions as jpositions  # noqa: E402
from spades_for_blackbird_tpu.graph.from_gfa import (  # noqa: E402
    graph_from_gfa as jgraph_from_gfa)
from spades_for_blackbird_tpu.kmers import hll as jhll  # noqa: E402
from spades_for_blackbird_tpu.mts import binning as jbinning  # noqa: E402
from spades_for_blackbird_tpu.parallel.kmer_exchange import (  # noqa: E402
    kmer_hash as jkmer_hash)
from spades_for_blackbird_tpu_torch.graph import positions  # noqa: E402
from spades_for_blackbird_tpu_torch.graph.from_gfa import (  # noqa: E402
    graph_from_gfa)
from spades_for_blackbird_tpu_torch.kmers import hll  # noqa: E402
from spades_for_blackbird_tpu_torch.mts import binning  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402
from test_torch_tools import (  # noqa: E402
    _single_device, build_gfa, random_dna, run_both, tile, write_reads)

assert _single_device  # the autouse fixture, imported to apply here


# rank bits where the JAX package's float32 log2 (XLA on the CPU) is off
# by one: log2(8192) and log2(32768) come out just under 13 and 15
XLA_LOG2_OFF = (8192, 32768)


def _jax_rank(rest):
    """The JAX package's rank (hll.py:44-45) of uint32 rank bits."""
    width = 32 - 12
    r = jnp.asarray(rest)
    hb = jnp.floor(jnp.log2(jnp.maximum(r, 1).astype(jnp.float32))
                   ).astype(jnp.int32)
    return np.asarray(jnp.where(r == 0, width + 1, width - hb))


def test_register_rank_against_jax_on_every_value():
    """The port's integer highest-bit rank is the exact leading-zero
    count + 1 on all 2^20 values of the 20 rank bits. The JAX package's
    float32-log2 rank agrees with it on every value but the two where
    XLA's CPU log2 rounds below an exact power of two (8192 and 32768:
    rank 8 and 6 where 7 and 5 are exact)."""
    rest = np.arange(1 << 20, dtype=np.uint32)
    got = hll.register_rank(torch.from_numpy(rest.astype(np.int64))).numpy()
    exact = np.where(rest == 0, 21, 20 - np.floor(np.log2(np.maximum(
        rest, 1).astype(np.float64))).astype(np.int64))
    np.testing.assert_array_equal(got, exact)
    want = _jax_rank(rest)
    off = np.nonzero(got != want)[0]
    assert off.tolist() == list(XLA_LOG2_OFF)
    assert (want[off] - got[off]).tolist() == [1, 1]
    assert got[0] == 21 and got[1] == 20 and got[-1] == 1


@pytest.mark.parametrize("W", [1, 2, 3, 5])
def test_kmer_hash_matches_jax(W):
    rng = np.random.default_rng(W)
    words = rng.integers(0, 1 << 32, size=(5000, W), dtype=np.uint64)
    words[:4, 0] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = np.asarray(jkmer_hash(jnp.asarray(words.astype(np.uint32))))
    got = hll.kmer_hash(torch.from_numpy(words.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _reads(size=12_000, seed=3):
    genome = simulate.random_genome(size, seed=seed, repeats=[(300, 2)])
    r1, _, r2, _ = simulate.simulate_paired_reads(
        genome, size // 10, read_len=100, error_rate=0.003, seed=seed + 1)
    codes, lengths = dna.encode_reads(r1 + r2 + ["ACGTNACGT" * 8, "ACG"])
    return genome, codes, lengths


@pytest.mark.parametrize("k", [21, 32, 33])
def test_hll_registers_and_estimate_match_jax(k):
    """Registers equal to the JAX package's. The registers could differ
    only through a k-mer whose rank bits are one of ``XLA_LOG2_OFF``:
    none of this data's are, which the test checks, so the comparison
    holds the hash, the register index and the scatter-max."""
    _, codes, lengths = _reads()
    from spades_for_blackbird_tpu.ops import kmer as jkmer
    canon, valid, _ = jkmer.extract_canonical_kmers(
        jnp.asarray(codes), jnp.asarray(lengths), k)
    rest = np.asarray(jkmer_hash(canon.reshape(-1, canon.shape[-1])))[
        np.asarray(valid).reshape(-1)] >> 12
    assert not np.isin(rest, XLA_LOG2_OFF).any()
    want = np.asarray(jhll.hll_registers(jnp.asarray(codes),
                                         jnp.asarray(lengths), k))
    got = hll.hll_registers(codes, lengths, k, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert hll.estimate(got) == jhll.estimate(want)
    # several chunks merge to the same registers
    small = hll.CPU_CHUNK_READS
    try:
        hll.CPU_CHUNK_READS = 333
        again = hll.hll_registers(codes, lengths, k, device="cpu")
    finally:
        hll.CPU_CHUNK_READS = small
    assert torch.equal(again, got)


def test_hll_estimate_is_near_the_distinct_count():
    genome, codes, lengths = _reads(30_000, 8)
    est = hll.estimate_kmer_cardinality(codes, lengths, 21, device="cpu")
    from spades_for_blackbird_tpu_torch.kmers import counter
    t = counter.count_kmers(torch.from_numpy(codes),
                            torch.from_numpy(lengths), 21)
    assert abs(est - int(t.num)) / int(t.num) < 0.06


def _ranges(pos):
    return {e: [dataclasses.astuple(r) for r in rs] for e, rs in pos.items()}


def test_edge_positions_match_jax(tmp_path):
    """A 9 kb genome with repeats (reference sequences longer than one
    kernel row of 4,096 bases), a reverse-complemented part and a
    sequence shorter than k + 1."""
    genome = simulate.random_genome(9000, seed=24, repeats=[(300, 3)])
    gfa_p = build_gfa(tmp_path, tile(genome, L=60, step=3), k=21)
    seqs = {"chr": genome, "part": nd.rc(genome[2000:7000]),
            "mut": genome[:500] + "N" + genome[501:3000], "tiny": "ACGT"}
    g = graph_from_gfa(gfa_p, device="cpu")
    jg = jgraph_from_gfa(gfa_p)
    got = positions.fill_edge_positions(g, seqs, device="cpu")
    want = jpositions.fill_edge_positions(jg, seqs)
    assert _ranges(got) == _ranges(want)
    assert positions.positions_table(g, seqs, device="cpu") == \
        jpositions.positions_table(jg, seqs)
    covered = sum(r.seq_end - r.seq_start for rs in got.values()
                  for r in rs if r.name == "chr")
    assert covered >= len(genome)


def _binned_gfa(tmp_path):
    a, b = random_dna(400, 4), random_dna(400, 5)
    reads = tile(a) * 3 + tile(b) * 3 + [a[200:230] + b[100:130]]
    gfa_p = build_gfa(tmp_path, reads)
    g, names = jgraph_from_gfa(gfa_p, return_names=True)
    from spades_for_blackbird_tpu.graph.graph import (
        edge_codes_host as jedge_codes_host)
    ann = {}
    for e, name in names.items():
        s = dna.decode_codes(jedge_codes_host(g, e))
        for genome, label in ((a, "BIN_A"), (b, "BIN_B")):
            if len(s) > 60 and (s in genome or s in nd.rc(genome)):
                ann[name] = label
    return gfa_p, ann, reads


def test_binning_matches_jax(tmp_path):
    gfa_p, ann, reads = _binned_gfa(tmp_path)
    g, names = graph_from_gfa(gfa_p, return_names=True, device="cpu")
    jg, jnames = jgraph_from_gfa(gfa_p, return_names=True)
    assert names == jnames
    edge_bins = {e: ann[n] for e, n in names.items() if n in ann}
    labels = binning.propagate_bins(g, edge_bins)
    assert labels == jbinning.propagate_bins(jg, edge_bins)
    assert binning.binning_stats(g, labels) == \
        jbinning.binning_stats(jg, labels)
    codes, lengths = dna.encode_reads(reads)
    got = binning.bin_reads(g, labels, codes, lengths, device="cpu")
    want = jbinning.bin_reads(jg, labels, codes, lengths)
    assert sorted(got) == sorted(want) == ["BIN_A", "BIN_B"]
    for b in got:
        np.testing.assert_array_equal(got[b], want[b])


def test_prop_binning_tool(tmp_path, capsys):
    gfa_p, ann, reads = _binned_gfa(tmp_path)
    ann_p = tmp_path / "in" / "binning.ann"
    binning.write_annotation(str(ann_p), ann)
    rp = write_reads(tmp_path / "in" / "reads.fa", reads)
    for extra in ([], ["--reads", rp]):
        out = tmp_path / f"run{len(extra)}"
        out.mkdir()
        _, _, err, files = run_both(out, capsys, lambda d: [
            "prop-binning", gfa_p, str(ann_p), "-o", f"{d}/prop.ann",
            "--reads-out-prefix", f"{d}/binned"] + extra)
        assert "bin BIN_A:" in err
        assert len(files) == (1 if not extra else 3)


def test_multiplicity_counter_and_contig_abundance_tools(tmp_path, capsys):
    genome = random_dna(500, 6)
    d = tmp_path / "in"
    d.mkdir()
    s1 = write_reads(d / "s1.fa", tile(genome) * 3)
    s2 = write_reads(d / "s2.fa", tile(genome[:300]))
    run1 = tmp_path / "count"
    run1.mkdir()
    run_both(run1, capsys, lambda o: [
        "kmer-multiplicity-counter", s1, s2, "-k", "21", "-o",
        f"{o}/prof.npz", "--min-mult", "1"])
    contigs = d / "c.fa"
    contigs.write_text(f">c1\n{genome}\n>c2\n{genome[100:400]}\n"
                       f">c3\n{random_dna(100, 7)}\n")
    for stat in ("median", "mean"):
        run2 = tmp_path / f"abund_{stat}"
        run2.mkdir()
        _, _, _, files = run_both(run2, capsys, lambda o: [
            "contig-abundance", str(contigs),
            str(run1 / "jax" / "prof.npz"), "-o", f"{o}/abund.tsv",
            "--stat", stat])
        assert files["abund.tsv"].count(b"\n") == 3
