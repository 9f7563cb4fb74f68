"""The PyTorch port's hybrid long-read path vs the JAX package's: the
banded edit distance, long-read alignment (a read longer than the
kernel's row included), the graph-path fill, hybrid gap closing,
repeat resolution with long reads (the resolver's ``kind="long"`` path),
and ``-1/-2 --pacbio``, ``--nanopore`` and ``--sanger`` through both
command lines.

Inputs are made from numpy seeds and go through both packages; graphs
built by the JAX package cross with ``interop``. Integer results must be
bit-equal, the command lines' files byte-identical under
``--checkpoints none``. Two reference faults are pinned: the JAX command
line cannot save the context after a hybrid stage, and its scaffolding
raises once long reads give a path of two edges or more; the port runs
both to the end.
"""

import os
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))

import test_long_read as jfix  # noqa: E402
from spades_for_blackbird_tpu import cli as jcli  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spades_for_blackbird_tpu.graph import construct as jconstruct  # noqa: E402
from spades_for_blackbird_tpu.graph import graph as jgraph  # noqa: E402
from spades_for_blackbird_tpu.mapping import long_read as jlr  # noqa: E402
from spades_for_blackbird_tpu.ops import align as jalign  # noqa: E402
from spades_for_blackbird_tpu.ops import dna as jdna  # noqa: E402
from spades_for_blackbird_tpu.path_extend import resolver as jresolver  # noqa: E402
from spades_for_blackbird_tpu.pipeline import assemble as jassemble  # noqa: E402
from spades_for_blackbird_tpu.pipeline import spades_stages as jstages  # noqa: E402
from spades_for_blackbird_tpu.pipeline import stages as jpstages  # noqa: E402
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import cli, interop  # noqa: E402
from spades_for_blackbird_tpu_torch.mapping import long_read  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import align  # noqa: E402
from spades_for_blackbird_tpu_torch.path_extend import resolver  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import assemble  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import spades_stages  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import stages  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

CPU = ["--device", "cpu"]
# what the hybrid command lines write (every file but the log)
OUTPUTS = ("contigs.fasta", "scaffolds.fasta", "before_rr.fasta",
           "assembly_graph_with_scaffolds.gfa", "assembly_graph.fastg",
           "contigs.paths", "scaffolds.paths", "final.lib_data",
           "scaffold_graph.scg", "scaffold_graph.dot")


@pytest.fixture(autouse=True)
def _reference_logger_reset(monkeypatch):
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    jlogger.configure()
    yield
    # the JAX command line leaves a writer on its closed log file
    jlogger.configure()


def port_graph(jg):
    return interop.graph_from_numpy(
        interop.fields_of(jg, interop.GRAPH_FIELDS), jg.k)


def assert_graphs_equal(g, jg):
    a = interop.graph_to_numpy(g)
    b = interop.fields_of(jg, interop.GRAPH_FIELDS)
    assert g.capacity == jg.capacity and g.k == jg.k
    for name in interop.GRAPH_FIELDS:
        if b[name] is None:
            assert a[name] is None, name
        else:
            assert np.array_equal(a[name], b[name]), name


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- banded edit distance ---------------------------------------------------

def _pairs(rng, B, L, band):
    """Random pairs of one width: similar pairs (10% edits), unrelated
    pairs, length differences inside and outside the band, length 0 and
    1 on either side."""
    a = rng.integers(0, 4, (B, L)).astype(np.uint8)
    b = rng.integers(0, 4, (B, L)).astype(np.uint8)
    similar = rng.random(B) < 0.6
    edits = rng.random((B, L)) < 0.1
    b[similar] = np.where(edits[similar],
                          rng.integers(0, 5, (int(similar.sum()), L)),
                          a[similar]).astype(np.uint8)
    a_len = rng.integers(0, L + 1, B).astype(np.int32)
    shift = rng.integers(-2 * band - 3, 2 * band + 4, B)
    b_len = np.clip(a_len + shift, 0, L).astype(np.int32)
    a_len[:3], b_len[:3] = (0, 1, 0), (0, 0, 1)
    a_len[3], b_len[3] = L, L - band - 1       # just outside the band
    a_len[4], b_len[4] = L - band, L           # on its edge
    for x, n in ((a, a_len), (b, b_len)):      # padding after the length
        x[np.arange(L)[None, :] >= n[:, None]] = 4
    return a, a_len, b, b_len


@pytest.mark.parametrize("band", [4, 17, 48])
def test_banded_edit_distance_matches_jax(band):
    rng = np.random.default_rng(band)
    a, a_len, b, b_len = _pairs(rng, 64, 160, band)
    want = np.asarray(jalign.banded_edit_distance(a, a_len, b, b_len,
                                                  band=band))
    got = align.banded_edit_distance(t(a), t(a_len), t(b), t(b_len), band)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        align.banded_edit_distance_plain(t(a), t(a_len), t(b), t(b_len),
                                         band).numpy(), want)


def test_banded_edit_distance_is_levenshtein_inside_the_band():
    """Where the optimum stays in the band the result is the exact
    Levenshtein distance (a plain O(n*m) DP on the host)."""
    rng = np.random.default_rng(3)
    a, a_len, b, b_len = _pairs(rng, 24, 40, 40)
    got = align.banded_edit_distance(t(a), t(a_len), t(b), t(b_len), 40)
    for i in range(24):
        x, y = a[i, :a_len[i]], b[i, :b_len[i]]
        prev = np.arange(len(y) + 1)
        for r in range(1, len(x) + 1):
            cur = np.empty_like(prev)
            cur[0] = r
            for c in range(1, len(y) + 1):
                sub = 0 if (x[r - 1] == y[c - 1] and y[c - 1] < 4) else 1
                cur[c] = min(prev[c - 1] + sub, prev[c] + 1, cur[c - 1] + 1)
            prev = cur
        assert int(got[i]) == int(prev[-1]), i


def test_banded_wrapper_uses_plain_version_on_cpu():
    kernel = align.BandedEditDistanceKernel()
    rng = np.random.default_rng(4)
    a, a_len, b, b_len = _pairs(rng, 8, 30, 5)
    assert torch.equal(
        kernel(t(a), t(a_len), t(b), t(b_len), 5),
        align.banded_edit_distance_plain(t(a), t(a_len), t(b), t(b_len), 5))
    assert kernel.launches == 0
    meta = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernel(meta, lens, meta, lens, 5)


# -- long-read alignment and hybrid gap closing ------------------------------

def _hole_case():
    """tests/test_long_read.py::test_hybrid_gap_closing's graph (a 900 bp
    genome with a 100 bp hole in its short reads) and noisy long reads
    over the hole, plus one over the whole genome."""
    genome = jfix.random_dna(900, 4)
    reads = jfix.tile(genome[:400]) + jfix.tile(genome[500:])
    g = jconstruct.graph_from_reads(*jdna.encode_reads(reads), jfix.K)
    lrs = [jfix.noisy(genome[250:750], 0.08, 10 + i) for i in range(4)]
    lrs.append(jfix.noisy(genome, 0.10, 3))
    return g, jdna.encode_reads(lrs)


def _long_read_case():
    """A 6 kb genome tiled by short reads, and noisy long reads: two
    longer than the kernel's rows of 4096 bases, one a reverse
    complement, and one unrelated."""
    genome = jfix.random_dna(6000, 8)
    g = jconstruct.graph_from_reads(
        *jdna.encode_reads(jfix.tile(genome, L=60, step=6)), jfix.K)
    rc = {"A": "T", "C": "G", "G": "C", "T": "A"}
    lrs = [jfix.noisy(genome[200:5800], 0.10, 21),
           jfix.noisy(genome[:4600], 0.12, 22),
           "".join(rc[c] for c in reversed(
               jfix.noisy(genome[1000:3000], 0.10, 23))),
           jfix.random_dna(700, 24),
           jfix.noisy(genome[5000:5100], 0.05, 25)]
    return g, jdna.encode_reads(lrs)


@pytest.mark.parametrize("case", [_hole_case, _long_read_case])
def test_align_long_reads_matches_jax(case):
    jg, (lc, ll) = case()
    want = interop.long_read_alignments_to_numpy(
        jlr.align_long_reads(jg, lc, ll))
    got = interop.long_read_alignments_to_numpy(
        long_read.align_long_reads(port_graph(jg), lc, ll, device="cpu"))
    assert want.keys() == got.keys()
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    assert got["chain_len"].sum() > 0
    if ll.max() > 4096:  # the row cut: hits past the first row
        assert got["read_hi"].max() > 4096


def test_align_long_reads_chunks_change_nothing(monkeypatch):
    jg, (lc, ll) = _long_read_case()
    g = port_graph(jg)
    whole = interop.long_read_alignments_to_numpy(
        long_read.align_long_reads(g, lc, ll, device="cpu"))
    monkeypatch.setattr(long_read, "CPU_CHUNK_WINDOWS", 3000)
    assert len(long_read._read_chunks(ll, 13, torch.device("cpu"))) == 3
    chunked = interop.long_read_alignments_to_numpy(
        long_read.align_long_reads(g, lc, ll, device="cpu"))
    for name in whole:
        assert np.array_equal(chunked[name], whole[name]), name


def test_hybrid_close_gaps_matches_jax():
    jg, (lc, ll) = _hole_case()
    jg2, jn = jlr.hybrid_close_gaps(jg, lc, ll)
    g2, n = long_read.hybrid_close_gaps(port_graph(jg), lc, ll,
                                        device="cpu")
    assert n == jn == 1
    assert_graphs_equal(g2, jg2)


def test_graph_path_fill_matches_jax():
    """tests/test_long_read.py::test_graph_path_fill_prefers_graph_bases'
    graph and gap, with read errors of growing number: the graph's bases
    while the edit bound holds, then no fill."""
    from spades_for_blackbird_tpu.graph import condense
    from spades_for_blackbird_tpu.graph.graph import compact_graph, edge_mask
    from spades_for_blackbird_tpu.kmers import counter, extension
    K = 21
    rng = np.random.default_rng(31)
    a = "".join(rng.choice(list("ACGT"), size=300))
    m = "".join(rng.choice(list("ACGT"), size=150))
    b = "".join(rng.choice(list("ACGT"), size=300))
    flip = {"A": "C", "C": "G", "G": "T", "T": "A"}
    alt1 = a[-40:] + "".join(flip[c] for c in m[:20])
    alt2 = "".join(flip[c] for c in m[-20:]) + b[:40]
    genome = a + m + b
    reads = [genome[i:i + 60]
             for i in range(0, len(genome) - 60 + 1)] + [alt1, alt2] * 3
    codes, lengths = jdna.encode_reads(reads)
    kp1 = counter.count_kmers(codes, lengths, K + 1)
    vt = extension.build_vertex_table(kp1, K)
    jg, _ = compact_graph(condense.build_graph(kp1, vt, K))
    g = port_graph(jg)
    alive = np.asarray(edge_mask(jg))
    sv, ev = np.asarray(jg.start_v), np.asarray(jg.end_v)
    ln, starts = np.asarray(jg.seq_len), np.asarray(jg.seq_start)
    flat = np.asarray(jg.seq_flat)
    ids = [int(e) for e in np.nonzero(alive)[0]]
    triples = [(eA, eM, eB) for eA in ids for eM in ids for eB in ids
               if len({eA, eM, eB}) == 3 and ev[eA] == sv[eM]
               and ev[eM] == sv[eB] and 100 <= ln[eM] <= 250]
    eA, eM, eB = triples[0]
    truth = flat[starts[eM] + K: starts[eM] + ln[eM] - K].copy()
    for n_errors in (0, 2, 12, 60):
        noisy = truth.copy()
        at = rng.choice(len(noisy), n_errors, replace=False)
        noisy[at] = (noisy[at] + 1) % 4
        want = jlr._graph_path_fill(jg, eA, eB, noisy)
        got = long_read._graph_path_fill(g, eA, eB, noisy)
        assert (want is None) == (got is None), n_errors
        if want is not None:
            assert np.array_equal(got, want)
    assert long_read._graph_path_fill(g, eA, eB, truth) is not None


# -- repeat resolution with long reads ---------------------------------------

def _repeat_reads(root):
    """A 6 kb genome with a 500 bp repeat in two copies: FR pairs (100
    bp, insert 300, cannot cross the repeat) at 40x, and noisy long
    reads of 1.5-2.5 kb that do."""
    rng = np.random.default_rng(61)
    genome = simulate.random_genome(6000, seed=61, repeats=[(500, 2)])
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, 1200, read_len=100, insert_mean=300, insert_sd=20,
        error_rate=0.002, seed=62)
    paths = [os.path.join(root, f"rep_{m}.fq") for m in (1, 2)]
    simulate.write_fastq(paths[0], r1, q1)
    simulate.write_fastq(paths[1], r2, q2)
    lrs = []
    for i in range(12):
        lo = int(rng.integers(0, 6000 - 2500))
        lrs.append(jfix.noisy(genome[lo:lo + int(rng.integers(1500, 2500))],
                              0.10, 70 + i))
    lr_path = os.path.join(root, "rep_long.fa")
    with open(lr_path, "w") as f:
        for i, s in enumerate(lrs):
            f.write(f">lr{i}\n{s}\n")
    return paths, lr_path, jdna.encode_reads(lrs)


@pytest.fixture(scope="module")
def repeat_run(tmp_path_factory):
    """``-1/-2 --nanopore -k 21 --only-assembler --checkpoints all`` on
    the repeat genome through the port: (root, argv, output, long
    reads)."""
    root = tmp_path_factory.mktemp("repeat")
    (p1, p2), lr_path, long_reads = _repeat_reads(str(root))
    argv = ["-1", p1, "-2", p2, "--nanopore", lr_path, "-k", "21",
            "--only-assembler", "--checkpoints", "all"]
    assert cli.main(argv + ["-o", str(root / "port")] + CPU) == 0
    return root, argv, root / "port", long_reads


def _rr_inputs(saves):
    """The graph and paired libraries before repeat resolution, loaded
    by each package from the port's saves."""
    jctx = jpstages.PipelineContext.load(saves)
    ctx = stages.PipelineContext.load(saves, "cpu")
    return (jctx.graph, jstages._paired_lib_arrays(jctx)), \
        (ctx.graph, spades_stages._paired_lib_arrays(ctx))


def test_repeat_resolution_with_long_reads_matches_jax(repeat_run):
    """The long-read branch of ``repeat_resolution_multi`` without
    scaffolding (where the JAX package runs): equal contigs and paths,
    and long-read paths of two edges or more exist."""
    _, _, out, (lc, ll) = repeat_run
    (jg, jlibs), (g, libs) = _rr_inputs(str(out / "saves" /
                                            "hybrid_aligning_2"))
    jpaths, paths = {}, {}
    want = jassemble.repeat_resolution_multi(
        jg, jlibs, long_reads=(lc, ll), paths_out=jpaths)
    got = assemble.repeat_resolution_multi(
        g, libs, long_reads=(lc, ll), paths_out=paths, device="cpu")
    assert got == want
    assert [list(map(int, p)) for p in paths["contigs"]] == \
        [list(map(int, p)) for p in jpaths["contigs"]]
    alns = long_read.align_long_reads(g, lc, ll, device="cpu")
    assert any(len(a.edge_path) >= 2 for a in alns)


def test_resolver_long_read_paths_match_jax(repeat_run):
    """``resolve_paths_multi`` with a ``kind="long"`` library alone, on
    the same graph and long-read paths in both packages."""
    _, _, out, (lc, ll) = repeat_run
    (jg, _), (g, _) = _rr_inputs(str(out / "saves" / "hybrid_aligning_2"))
    lr_paths = [(a.edge_path, 1.0)
                for a in jlr.align_long_reads(jg, lc, ll)
                if len(a.edge_path) >= 2]
    assert lr_paths
    want = jresolver.resolve_paths_multi(
        jg, [jresolver.LibSpec(None, kind="long", read_paths=lr_paths)])
    got = resolver.resolve_paths_multi(
        g, [resolver.LibSpec(None, kind="long", read_paths=lr_paths)])
    assert interop.path_set_to_numpy(got) == \
        [[int(e) for e in p] for p in want.paths]


def test_scaffolding_with_long_read_paths(repeat_run):
    """Pins a reference fault: with scaffolding, the JAX package reads
    the long-read library's insert size, which it has not, and raises;
    the port scaffolds with the paired libraries' and finishes (the
    command line ran to the end on the same data)."""
    _, _, out, (lc, ll) = repeat_run
    (jg, jlibs), (g, libs) = _rr_inputs(str(out / "saves" /
                                            "hybrid_aligning_2"))
    with pytest.raises(AttributeError):
        jassemble.repeat_resolution_multi(jg, jlibs, with_scaffolds=True,
                                          long_reads=(lc, ll))
    contigs, scaffolds = assemble.repeat_resolution_multi(
        g, libs, with_scaffolds=True, long_reads=(lc, ll), device="cpu")
    assert contigs and scaffolds
    assert (out / "scaffolds.fasta").exists()
    assert "== STAGE repeat_resolution done" in (
        out / "spades.log").read_text()


# -- hybrid gap closing at scale: the 1/20 cut of chip_smoke.py phase 15 ------

def test_hybrid_joins_on_the_cut_match_jax():
    """``chip_smoke.py`` phase 15 (a)'s data cut to 1/20 (230 kb, 24
    holes of 400-1,000 bases, long reads at 5x with 10% errors), the
    graph assembled by the port at k=55: both packages join the same
    holes into the same graph. A hole is joined only where two long
    reads of one orientation cross it with no other seed candidate in
    between; a random 15-mer of a read (three overlapping 13-mer seeds,
    min_votes = 3) matches the graph at about 2 * genome / 4^15 a base,
    so the chains break inside holes ever more often as the genome
    grows: at 4.6 Mb (phase 15 (a)) about every 100 bases. Here one
    stage joins 10 of the 24 holes in both packages."""
    import importlib
    smoke = importlib.import_module("chip_smoke")
    genome, g, _, _, holes = smoke.hybrid_genome(smoke.HYBRID_CUT,
                                                 n_clusters=0)
    rng = np.random.default_rng(153)
    c1, _, c2, _, in_hole = smoke.hybrid_pairs(rng, g, holes)
    lrs = smoke.long_reads(rng, g, smoke.LONG_COVERAGE, smoke.LONG_LEN,
                           smoke.LONG_ERROR)
    reads = np.concatenate([c1[~in_hole], c2[~in_hole]])
    res = assemble.assemble_single_k(
        reads, np.full(len(reads), reads.shape[1], np.int32), 55,
        device="cpu")
    lc, ll = jdna.encode_reads([jdna.decode_codes(r) for r in lrs])
    jg = jgraph.Graph(**{f: jnp.asarray(v) for f, v in
                         interop.graph_to_saved_arrays(res.graph).items()},
                      k=55)
    jg2, jn = jlr.hybrid_close_gaps(jg, lc, ll)
    g2, n = long_read.hybrid_close_gaps(res.graph, lc, ll, device="cpu")
    assert n == jn >= len(holes) // 4
    assert_graphs_equal(g2, jg2)


# -- the command lines --------------------------------------------------------

def _hole_reads(root):
    """FR pairs (100 bp, insert 300) of a 3 kb genome at 40x, none with a
    mate in the hole at 1,400-1,600, and five noisy long reads (10%
    errors) across the hole."""
    genome = simulate.random_genome(3000, seed=21)
    r1, q1, r2, q2 = [], [], [], []
    for part, seed in ((genome[:1400], 31), (genome[1600:], 32)):
        got = simulate.simulate_paired_reads(
            part, len(part) * 40 // 200, read_len=100, insert_mean=300,
            insert_sd=20, error_rate=0.002, seed=seed)
        for acc, x in zip((r1, q1, r2, q2), got):
            acc += x
    paths = [os.path.join(root, f"hole_{m}.fq") for m in (1, 2)]
    simulate.write_fastq(paths[0], r1, q1)
    simulate.write_fastq(paths[1], r2, q2)
    lr_path = os.path.join(root, "hole_long.fa")
    with open(lr_path, "w") as f:
        for i in range(5):
            s = jfix.noisy(genome[1000 + 37 * i:2000 + 29 * i], 0.10, 40 + i)
            f.write(f">lr{i}\n{s}\n")
    return paths, lr_path


@pytest.fixture(scope="module")
def hybrid_runs(tmp_path_factory):
    """``-1/-2 --pacbio -k 21 --only-assembler --checkpoints none``
    through the JAX command line: (argv without the long-read flag, the
    long reads, the JAX package's output)."""
    root = tmp_path_factory.mktemp("hybrid")
    (p1, p2), lr_path = _hole_reads(str(root))
    argv = ["-1", p1, "-2", p2, "-k", "21", "--only-assembler",
            "--checkpoints", "none"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
        try:
            assert jcli.main(argv + ["--pacbio", lr_path, "-o",
                                     str(root / "jax")]) == 0
        finally:
            jlogger.configure()
    return argv, lr_path, root / "jax"


@pytest.mark.parametrize("flag", ["--pacbio", "--nanopore", "--sanger"])
def test_hybrid_command_lines_match_jax(hybrid_runs, tmp_path, flag):
    argv, lr_path, jax_out = hybrid_runs
    out = tmp_path / "port"
    assert cli.main(argv + [flag, lr_path, "-o", str(out)] + CPU) == 0
    for name in OUTPUTS:
        assert (out / name).read_bytes() == (jax_out / name).read_bytes(), \
            name
    log = (out / "spades.log").read_text()
    assert "hybrid gap closing: 1 joins from 5 long reads" in log
    assert "== STAGE hybrid_aligning_2\n" in log


def test_hybrid_default_checkpoints_and_continue(hybrid_runs, tmp_path):
    """Pins a reference fault: the JAX command line keeps the long reads
    in ``ctx.params``, and its save after ``hybrid_aligning`` raises
    ``TypeError`` under the default ``--checkpoints last``. The port
    reads the files again where they are needed: it runs to the end,
    stops after ``hybrid_aligning_2`` and resumes from that save with
    ``--continue``, writing what the straight run writes."""
    argv, lr_path, jax_out = hybrid_runs
    argv = [x for x in argv if x not in ("--checkpoints", "none")]
    argv += ["--pacbio", lr_path]
    straight = tmp_path / "straight"
    assert cli.main(argv + ["-o", str(straight)] + CPU) == 0
    resumed = tmp_path / "resumed"
    assert cli.main(argv + ["-o", str(resumed), "--stop-after",
                            "hybrid_aligning_2"] + CPU) == 0
    assert (resumed / "saves" / "hybrid_aligning_2" / "pack.npz").exists()
    assert not (resumed / "contigs.fasta").exists()
    assert cli.main(argv + ["-o", str(resumed), "--continue"] + CPU) == 0
    for name in OUTPUTS:
        assert (resumed / name).read_bytes() == \
            (straight / name).read_bytes() == \
            (jax_out / name).read_bytes(), name
    assert "resuming from saves of stage 'hybrid_aligning_2'" in (
        resumed / "spades.log").read_text()
    shutil.rmtree(straight)
