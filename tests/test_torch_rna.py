"""The PyTorch port's RNA modes vs the JAX package's: the mismatch-tip
condition and the low-complexity clippers on tests/test_simplification.py's
graphs (:157-206), superbubble collapse and the strand split on
tests/test_superbubble_ss_split.py's (:39-118), and ``--rna --ss fr``,
``--rnaviral``, ``--corona`` without HMMs and ``--moleculo`` through both
command lines.

Every pass is handed the same graph (built by the JAX package, carried
over with ``interop``). Integers and sequences must be equal; coverage is
held at rtol 1e-5, since recondense sums float32 coverage in another
order than XLA. The command lines' output files must be byte-identical.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import naive_debruijn as nd  # noqa: E402
from spades_for_blackbird_tpu import cli as jcli  # noqa: E402
from spades_for_blackbird_tpu.graph import condense as jcondense  # noqa: E402
from spades_for_blackbird_tpu.graph import construct as jconstruct  # noqa: E402
from spades_for_blackbird_tpu.graph import graph as jgraph  # noqa: E402
from spades_for_blackbird_tpu.kmers import counter as jcounter  # noqa: E402
from spades_for_blackbird_tpu.kmers import extension as jext  # noqa: E402
from spades_for_blackbird_tpu.models import rna as jrna  # noqa: E402
from spades_for_blackbird_tpu.pipeline import gap_closer as jgap  # noqa: E402
from spades_for_blackbird_tpu.simplify import advanced as jadv  # noqa: E402
from spades_for_blackbird_tpu.simplify import passes as jpasses  # noqa: E402
from spades_for_blackbird_tpu.simplify import superbubble as jsb  # noqa: E402
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import cli, interop  # noqa: E402
from spades_for_blackbird_tpu_torch.models import rna  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import gap_closer  # noqa: E402
from spades_for_blackbird_tpu_torch.simplify import advanced  # noqa: E402
from spades_for_blackbird_tpu_torch.simplify import passes  # noqa: E402
from spades_for_blackbird_tpu_torch.simplify import superbubble  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

K = 15
COV_RTOL = 1e-5  # float32 sums in another order than XLA's
CPU = ["--device", "cpu"]
CLI_OUTPUTS = ("contigs.fasta", "scaffolds.fasta", "before_rr.fasta",
               "assembly_graph_with_scaffolds.gfa", "assembly_graph.fastg",
               "params.json")
PAIRED_OUTPUTS = ("contigs.paths", "scaffolds.paths", "final.lib_data",
                  "scaffold_graph.scg", "scaffold_graph.dot")


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


def assert_graphs_equal(g, jg):
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
            np.testing.assert_allclose(a[name], b[name], rtol=COV_RTOL,
                                       atol=0.0, err_msg=name)


def compact_k21(reads):
    """tests/test_simplification.py::_build_graph_for."""
    codes, lengths = dna.encode_reads(reads)
    kp1 = jcounter.count_kmers(codes, lengths, 22)
    vt = jext.build_vertex_table(kp1, 21)
    return jgraph.compact_graph(jcondense.build_graph(kp1, vt, 21))


def _mutate(c):
    return {"A": "C", "C": "G", "G": "T", "T": "A"}[c]


def mismatch_tip_graph():
    """tests/test_simplification.py:157-184: a tip two mismatches off
    its longer sibling."""
    rng = np.random.default_rng(17)
    a = "".join(rng.choice(list("ACGT"), size=200))
    b = "".join(rng.choice(list("ACGT"), size=200))
    main = a + b
    tip_seq = list(b[:60])
    tip_seq[40] = _mutate(tip_seq[40])
    tip_seq[50] = _mutate(tip_seq[50])
    tip = a[-40:] + "".join(tip_seq)
    reads = [main[i:i + 60] for i in range(0, len(main) - 60 + 1)] + \
        [tip[i:i + 60] for i in range(0, len(tip) - 60 + 1, 5)]
    return compact_k21(reads)


def polya_graph():
    """tests/test_simplification.py:187-206: an A-rich tip."""
    rng = np.random.default_rng(23)
    a = "".join(rng.choice(list("ACGT"), size=200))
    b = "".join(rng.choice(list("ACGT"), size=200))
    main = a + b
    polya_tip = a[-40:] + "".join(rng.choice(
        list("ACGT"), size=60, p=[0.88, 0.04, 0.04, 0.04]))
    reads = [main[i:i + 60] for i in range(0, len(main) - 60 + 1)] + \
        [polya_tip[i:i + 60] for i in range(0, len(polya_tip) - 60 + 1, 5)]
    return compact_k21(reads)


@pytest.mark.parametrize("max_diff", [3.0, 1.0, 0.05])
def test_mismatch_tip_mask_matches_jax(max_diff):
    jg, vs = mismatch_tip_graph()
    mask = advanced.mismatch_tip_mask(port_graph(jg), vs, max_diff)
    jmask = jadv.mismatch_tip_mask(jg, vs, max_diff)
    assert np.array_equal(mask, jmask)
    assert mask.any() == (max_diff >= 2.0)


@pytest.mark.parametrize("fixture", [mismatch_tip_graph, polya_graph])
def test_mismatch_tip_clause_clips_as_jax(fixture):
    """The 4-value tip clause: clip_tips with the mask as its
    ``require`` conjunct."""
    jg, vs = fixture()
    g = port_graph(jg)
    req = advanced.mismatch_tip_mask(g, vs, 3.0)
    out = passes.clip_tips(g, vs, 84, 1e5, 0.5, require=torch.from_numpy(req))
    jout = jpasses.clip_tips(jg, vs, jnp.int32(84), jnp.float32(1e5),
                             jnp.float32(0.5), require=jnp.asarray(req))
    assert_graphs_equal(out, jout)


@pytest.mark.parametrize("name", ["clip_low_complexity_tips",
                                  "remove_low_complexity_short_edges"])
@pytest.mark.parametrize("fixture", [polya_graph, mismatch_tip_graph])
def test_low_complexity_clippers_match_jax(name, fixture):
    jg, vs = fixture()
    out, ovs, n = getattr(advanced, name)(port_graph(jg), vs)
    jout, jvs, jn = getattr(jadv, name)(jg, vs)
    assert (ovs, n) == (jvs, jn)
    assert_graphs_equal(out, jout)
    if name == "clip_low_complexity_tips":
        assert (n >= 1) == (fixture is polya_graph)


def three_path_graph():
    """tests/test_superbubble_ss_split.py:39-62."""
    pre, post = random_dna(120, 10), random_dna(120, 11)
    mid_a = random_dna(40, 12)
    mid_b = mid_a[:18] + ("A" if mid_a[18] != "A" else "C") + mid_a[19:]
    mid_c = mid_a[:30] + ("G" if mid_a[30] != "G" else "T") + mid_a[31:]
    reads = (tile(pre + mid_a + post) * 6 + tile(pre + mid_b + post) * 2
             + tile(pre + mid_c + post) * 2)
    codes, lengths = dna.encode_reads(reads)
    return jconstruct.graph_from_reads(codes, lengths, K)


def long_interior_graph():
    """tests/test_superbubble_ss_split.py:65-77."""
    pre, post = random_dna(100, 20), random_dna(100, 21)
    mid_a, mid_b = random_dna(60, 22), random_dna(60, 23)
    reads = tile(pre + mid_a + post) * 4 + tile(pre + mid_b + post) * 4
    codes, lengths = dna.encode_reads(reads)
    return jconstruct.graph_from_reads(codes, lengths, K)


@pytest.mark.parametrize("fixture,max_length", [
    (three_path_graph, 400), (long_interior_graph, 30),
    (long_interior_graph, 1000)])
def test_superbubbles_match_jax(fixture, max_length):
    jg = fixture()
    out, nb = superbubble.collapse_superbubbles(port_graph(jg),
                                                max_length=max_length)
    jout, jnb = jsb.collapse_superbubbles(jg, max_length=max_length)
    assert nb == jnb
    assert_graphs_equal(out, jout)
    assert (nb >= 1) == (max_length >= 400)


def flip_reads():
    """tests/test_superbubble_ss_split.py:80-91: the left part of a
    genome read sense, the right part antisense."""
    genome = random_dna(700, 30)
    reads = tile(genome[:380]) * 3 + [nd.rc(r) for r in
                                      tile(genome[320:])] * 3
    return dna.encode_reads(reads)


def no_flip_reads():
    """tests/test_superbubble_ss_split.py:104-112."""
    return dna.encode_reads(tile(random_dna(600, 31)) * 4)


def two_strand_reads():
    """tests/test_superbubble_ss_split.py:115-118."""
    genome = random_dna(400, 32)
    return dna.encode_reads(tile(genome[:200]) * 2 + [
        nd.rc(r) for r in tile(genome[180:])] * 2)


@pytest.mark.parametrize("reads,kw", [
    (flip_reads, dict(bin_size=50, min_edge_len=200, coverage_margin=3.0)),
    (flip_reads, dict(bin_size=50, min_edge_len=200, coverage_margin=3.0,
                      ss_orientation="rf")),
    (no_flip_reads, dict(bin_size=50, min_edge_len=200)),
    (two_strand_reads, dict(bin_size=50, min_edge_len=100,
                            coverage_margin=2.0))])
def test_strand_split_matches_jax(reads, kw):
    codes, lengths = reads()
    jg = jconstruct.graph_from_reads(codes, lengths, K)
    out, n, vs = rna.split_edges_by_strand(port_graph(jg), codes, lengths,
                                           device="cpu", **kw)
    jout, jn, jvs = jrna.split_edges_by_strand(jg, codes, lengths, **kw)
    assert (n, vs) == (jn, jvs)
    assert_graphs_equal(out, jout)
    if reads is not two_strand_reads:
        assert (n >= 1) == (reads is flip_reads)


@pytest.mark.parametrize("orientation", ["fr", "rf"])
def test_strand_coverage_matches_jax(orientation):
    codes, lengths = two_strand_reads()
    jg = jconstruct.graph_from_reads(codes, lengths, K)
    g = port_graph(jg)
    got = rna.binned_strand_coverage(g, codes, lengths, 50, orientation,
                                     device="cpu")
    want = jrna.binned_strand_coverage(jg, codes, lengths, 50, orientation)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    fwd, rev = rna.strand_specific_coverage(g, codes, lengths, device="cpu")
    jfwd, jrev = jrna.strand_specific_coverage(jg, codes, lengths)
    assert np.array_equal(fwd, jfwd) and np.array_equal(rev, jrev)
    assert fwd.sum() > 0 and rev.sum() > 0
    assert np.array_equal(rna.dominant_strand_fraction(fwd, rev),
                          jrna.dominant_strand_fraction(jfwd, jrev))
    assert np.array_equal(
        rna.antisense_artifact_edges(g, fwd, rev, min_edge_len=100),
        jrna.antisense_artifact_edges(jg, jfwd, jrev, min_edge_len=100))


def test_strand_split_cuts_a_lone_transcript_read_in_pairs():
    """Pins a reference-side behaviour: the strand split maps every read
    alike, so the second mates of stranded FR pairs count on the other
    strand; a transcript with no antisense neighbour then reads forward
    near its 5' end and reverse near its 3' end, and is cut. Its first
    mates alone leave it whole."""
    transcript = random_dna(900, 34)
    rng = np.random.default_rng(35)
    first, second = [], []
    for s in rng.integers(0, len(transcript) - 250, 300):
        frag = transcript[s:s + 250]
        first.append(frag[:50])
        second.append(nd.rc(frag[-50:]))
    for reads, cut in ((first, False), (first + second, True)):
        codes, lengths = dna.encode_reads(reads)
        jg = jconstruct.graph_from_reads(codes, lengths, K)
        out, n, _ = rna.split_edges_by_strand(port_graph(jg), codes, lengths,
                                              device="cpu")
        jout, jn, _ = jrna.split_edges_by_strand(jg, codes, lengths)
        assert n == jn and (n >= 1) == cut
        assert_graphs_equal(out, jout)


def test_gap_closing_after_the_strand_split():
    """Pins a reference-side fault: the JAX package's gap closer sizes its
    degree tables 4E + 2, and the strand split's graph (no padding, the
    old vertex ids and new ones) outgrows them, so ``--rna --ss`` with a
    paired library raises there once an edge is split. The port sizes
    them by the largest vertex id too, and closes the gaps."""
    codes, lengths = flip_reads()
    jg = jconstruct.graph_from_reads(codes, lengths, K)
    jsplit, n, _ = jrna.split_edges_by_strand(
        jg, codes, lengths, bin_size=50, min_edge_len=200,
        coverage_margin=3.0)
    assert n == 1 and int(np.asarray(jsplit.start_v).max()) >= \
        4 * jsplit.capacity + 2
    mates = (codes, lengths, dna.revcomp_reads(
        torch.from_numpy(codes), torch.from_numpy(lengths)).numpy(), lengths)
    with pytest.raises(IndexError):
        jgap.close_gaps(jsplit, *mates)
    out, joined = gap_closer.close_gaps(port_graph(jsplit), *mates,
                                        device="cpu")
    assert joined == 0
    assert_graphs_equal(out, jsplit)


def _transcripts(path):
    """Stranded single-end 100 bp reads of a small transcriptome: a gene
    and its antisense neighbour overlapping by 400 bases (what the strand
    split targets), and a gene of three exons with an exon-skipping
    isoform (a bubble the superbubble pass sees)."""
    rng = np.random.default_rng(71)
    locus = simulate.random_genome(3000, seed=72)
    exons = [simulate.random_genome(400, seed=73 + i) for i in range(3)]
    transcripts = ((locus[:1700], 40), (nd.rc(locus[1300:]), 40),
                   ("".join(exons), 40), (exons[0] + exons[2], 15))
    reads = []
    for t, cov in transcripts:
        for _ in range(cov * len(t) // 100):
            p = int(rng.integers(0, len(t) - 100 + 1))
            r = list(t[p:p + 100])
            for q in np.nonzero(rng.random(100) < 0.002)[0]:
                r[q] = _mutate(r[q])
            reads.append("".join(r))
    simulate.write_fastq(path, reads, ["I" * len(r) for r in reads])


def _virus(root):
    """FR pairs of a 6 kb RNA virus as two haplotypes (2% apart), mixed
    80/20 at 60x total: what rnaviralSPAdes users send."""
    major = simulate.random_genome(6000, seed=81)
    rng = np.random.default_rng(82)
    minor = list(major)
    for p in rng.choice(len(major), 120, replace=False):
        minor[p] = _mutate(minor[p])
    r1, q1, r2, q2 = [], [], [], []
    for genome, pairs, seed in ((major, 1440, 83), ("".join(minor), 360,
                                                    84)):
        got = simulate.simulate_paired_reads(
            genome, pairs, read_len=100, insert_mean=300, insert_sd=25,
            error_rate=0.002, seed=seed)
        for acc, part in zip((r1, q1, r2, q2), got):
            acc += part
    paths = [os.path.join(root, f"virus_{m}.fq") for m in (1, 2)]
    simulate.write_fastq(paths[0], r1, q1)
    simulate.write_fastq(paths[1], r2, q2)
    return paths


RUNS = {"rna": ["--rna", "--ss", "fr"], "rnaviral": ["--rnaviral"],
        "corona": ["--corona"], "moleculo": ["--moleculo"]}


@pytest.fixture(scope="module")
def rna_runs(tmp_path_factory):
    """Each RNA-family mode through both command lines at -k 21:
    {run: (the port's output, the JAX package's)}."""
    root = tmp_path_factory.mktemp("rna")
    transcripts = str(root / "transcripts.fq")
    _transcripts(transcripts)
    virus = _virus(str(root))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
        for name, flags in RUNS.items():
            reads = (["-s", transcripts] if name == "rna"
                     else ["-1", virus[0], "-2", virus[1]])
            argv = reads + ["-k", "21", "--only-assembler",
                            "--checkpoints", "none"] + flags
            port, theirs = root / name / "port", root / name / "jax"
            assert cli.main(argv + ["-o", str(port)] + CPU) == 0
            try:
                assert jcli.main(argv + ["-o", str(theirs)]) == 0
            finally:
                jlogger.configure()
            runs[name] = (port, theirs)
    return runs


@pytest.mark.parametrize("run", list(RUNS))
def test_rna_command_lines_match_jax(rna_runs, run):
    port, theirs = rna_runs[run]
    names = CLI_OUTPUTS + (() if run == "rna" else PAIRED_OUTPUTS)
    for name in names:
        assert (port / name).read_bytes() == (theirs / name).read_bytes(), \
            name
    assert sorted(os.listdir(port)) == sorted(os.listdir(theirs))
    log = (port / "spades.log").read_text()
    assert f"mode: {run}" in log
    if run == "rna":
        split = [ln for ln in log.splitlines() if "ss edge split (fr)" in ln]
        assert split and "split 0 edges" not in split[0]
        assert split[0].split("]", 1)[1] in (theirs / "spades.log").read_text()
    if run == "corona":
        assert "warning: --corona without --custom-hmms" in log
