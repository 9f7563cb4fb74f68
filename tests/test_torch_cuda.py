"""Tests of the PyTorch port that need a CUDA card: the hand-written
k-mer extraction kernel (both entries), the banded edit distance and the
Viterbi kernels against their plain PyTorch versions, and the K ladder,
the error corrector, the read mapper, the paired index, the gap closer,
repeat resolution, mismatch correction, restricted edges, GFA input and
single-cell simplification on the card against the CPU. They skip
without a card. This file imports no JAX, so on a machine with the card
and without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spades_for_blackbird_tpu_torch.graph import from_gfa  # noqa: E402
from spades_for_blackbird_tpu_torch.hammer import correct  # noqa: E402
from spades_for_blackbird_tpu_torch.hammer import ionhammer  # noqa: E402
from spades_for_blackbird_tpu_torch.kmers import counter  # noqa: E402
from spades_for_blackbird_tpu_torch.mapping import (  # noqa: E402
    chunked, index, mapper)
from spades_for_blackbird_tpu_torch.ops import dna, kmer, kmer_cuda  # noqa: E402
from spades_for_blackbird_tpu_torch.paired import pair_info  # noqa: E402
from spades_for_blackbird_tpu_torch.io import gfa  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import (  # noqa: E402
    assemble, config, gap_closer, mismatch_correction)
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _reads(seed, R, L):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (R, L), dtype=np.uint8)
    codes[rng.random((R, L)) < 0.01] = 4
    lengths = np.full(R, L, np.int32)
    short = rng.random(R) < 0.1
    lengths[short] = rng.integers(1, L, short.sum())
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 4
    return codes, lengths


def _assert_kernel_equals_plain(card, codes, lengths, k):
    c = torch.from_numpy(codes).to(card)
    ln = torch.from_numpy(lengths).to(card)
    kernel = kmer_cuda.KmerExtractKernel()
    keys, valid = kernel(c, ln, k)
    ref_keys, ref_valid = kmer.extract_sort_keys(c, ln, k)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    assert torch.equal(keys, ref_keys)
    assert (valid is None) == (k % 16 != 0) == (ref_valid is None)
    if valid is not None:
        assert torch.equal(valid, ref_valid)


@pytest.mark.cuda
@pytest.mark.parametrize("L,k", [(100, 22), (100, 56), (150, 78),
                                 (150, 128), (40, 5)])
def test_kernel_matches_plain_on_card(card, L, k):
    _assert_kernel_equals_plain(card, *_reads(L + k, 2048, L), k)


@pytest.mark.cuda
@pytest.mark.parametrize("R,L,k", [
    (2051, 100, 56),   # R no multiple of the tile: a ragged last tile
    (1, 100, 56),      # one read
    (1, 40, 5), (333, 40, 5),
    (77, 150, 128),    # ragged, with the validity column
    (50, 33, 16),      # odd row length: 16-read alignment unit
    (9, 100, 100),     # one window a read
    (3, 4096, 127),    # the longest row
])
def test_kernel_matches_plain_at_ragged_shapes(card, R, L, k):
    _assert_kernel_equals_plain(card, *_reads(R + L + k, R, L), k)


@pytest.mark.cuda
def test_kernel_takes_reads_of_length_zero_and_misaligned_views(card):
    codes, lengths = _reads(9, 700, 100)
    lengths[::3] = 0
    codes[::3] = 4
    _assert_kernel_equals_plain(card, codes, lengths, 56)
    # a view that starts 100 bytes into its storage is 4-byte aligned
    # only: every tile then takes the threads' own loads
    c = torch.from_numpy(codes).to(card)[1:]
    ln = torch.from_numpy(lengths).to(card)[1:].contiguous()
    kernel = kmer_cuda.KmerExtractKernel()
    keys, _ = kernel(c, ln, 56)
    ref_keys, _ = kmer.extract_sort_keys(c, ln, 56)
    torch.cuda.synchronize()
    assert torch.equal(keys, ref_keys)


@pytest.mark.cuda
def test_count_kmers_card_equals_cpu(card):
    codes, lengths = _reads(3, 4096, 100)
    t = counter.count_kmers_chunked(torch.from_numpy(codes).to(card),
                                    torch.from_numpy(lengths).to(card), 56,
                                    chunk_reads=1024)
    c = counter.count_kmers_chunked(torch.from_numpy(codes),
                                    torch.from_numpy(lengths), 56,
                                    chunk_reads=1024)
    assert int(t.num) == int(c.num) and t.capacity == c.capacity
    assert torch.equal(t.kmers.cpu(), c.kmers)
    assert torch.equal(t.counts.cpu(), c.counts)


@pytest.mark.cuda
def test_wrapper_checks_its_inputs(card):
    kernel = kmer_cuda.KmerExtractKernel()
    codes = torch.zeros((4, 30), dtype=torch.uint8, device=card)
    lengths = torch.full((4,), 30, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        kernel(codes.to(torch.int32), lengths, 21)
    with pytest.raises(ValueError):
        kernel(codes, lengths.to(torch.int64), 21)
    with pytest.raises(ValueError):
        kernel(codes, lengths, 31)
    with pytest.raises(ValueError):
        kernel(codes[:, ::2], lengths, 11)
    with pytest.raises(ValueError):
        kernel(codes, lengths.cpu(), 21)
    wide = torch.zeros((2, kmer_cuda.MAX_L + 1), dtype=torch.uint8,
                       device=card)
    with pytest.raises(ValueError):
        kernel(wide, lengths[:2], 21)
    assert kernel.launches == 0


def _contigs(seed, sizes):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGT"), size=n)) for n in sizes]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [22, 34, 56])
def test_kernel_matches_plain_on_contig_windows(card, k):
    """What the ladder's second and later rungs hand the kernel: rows as
    wide as the reads, most of them full, one ragged tail a contig, whole
    short contigs as single rows, a row count that is no multiple of the
    tile's reads; aligned, and as a view that starts one row in."""
    seqs = _contigs(k, [k, k + 3, 99, 100, 101, 777, 4321, 15_013, 60_000])
    codes, lengths = assemble._windows_from_sequences(seqs, 100, k)
    if codes.shape[0] % 4 == 0:  # a tile holds a multiple of 4 such rows
        codes, lengths = codes[:-1], lengths[:-1]
    assert codes.shape[1] == 100
    assert len(set(lengths.tolist())) > 4
    _assert_kernel_equals_plain(card, codes, lengths, k)
    c = torch.from_numpy(codes).to(card)[1:]
    ln = torch.from_numpy(lengths).to(card)[1:].contiguous()
    keys, _ = kmer_cuda.KmerExtractKernel()(c, ln, k)
    ref_keys, _ = kmer.extract_sort_keys(c, ln, k)
    torch.cuda.synchronize()
    assert torch.equal(keys, ref_keys)


@pytest.mark.cuda
def test_multi_k_card_equals_cpu(card):
    genome = simulate.random_genome(20_000, seed=5, repeats=[(400, 2)])
    r1, _, r2, _ = simulate.simulate_paired_reads(
        genome, 4000, read_len=100, error_rate=0.002, seed=6)
    codes, lengths = dna.encode_reads(r1 + r2)
    before = kmer_cuda.extract_sort_keys.launches
    gpu = assemble.assemble_multi_k(codes, lengths, [21, 33, 55], device=card)
    # three rungs on the reads, two on contig windows
    assert kmer_cuda.extract_sort_keys.launches - before >= 5
    cpu = assemble.assemble_multi_k(codes, lengths, [21, 33, 55],
                                    device="cpu")

    def canonical(contigs):
        return sorted((min(s, dna.revcomp_str(s)), c) for s, c in contigs)
    a, b = canonical(gpu.contigs), canonical(cpu.contigs)
    assert [s for s, _ in a] == [s for s, _ in b]
    # float32 sums run in another order on the card
    np.testing.assert_allclose([c for _, c in a], [c for _, c in b],
                               rtol=1e-4)
    assert gpu.graph.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("R,L,k", [
    (2048, 100, 21),   # the error corrector's k
    (2051, 100, 56),   # a ragged last tile
    (77, 150, 128),    # with the validity column
    (50, 33, 16), (333, 40, 5), (9, 100, 100), (3, 4096, 127),
])
def test_strand_entry_matches_plain_on_card(card, R, L, k):
    codes, lengths = _reads(R + L + k + 1, R, L)
    lengths[::5] = 0
    for lo in (0, 1):  # aligned, and a view one row in
        c = torch.from_numpy(codes).to(card)[lo:]
        ln = torch.from_numpy(lengths).to(card)[lo:].contiguous()
        kernel = kmer_cuda.KmerExtractKernel()
        keys, valid, fwd = kernel.canonical_keys(c, ln, k)
        ref_keys, ref_valid, ref_fwd = kmer.extract_canonical_keys(c, ln, k)
        torch.cuda.synchronize()
        assert kernel.launches == 1
        assert torch.equal(keys, ref_keys)
        assert (valid is None) == (ref_valid is None)
        if valid is not None:
            assert torch.equal(valid, ref_valid)
        # defined on every window, the invalid ones too
        assert fwd.dtype == torch.bool and torch.equal(fwd, ref_fwd)


def _reads_with_quals(size, seed):
    genome = simulate.random_genome(size, seed=seed, repeats=[(400, 2)])
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, size // 5, read_len=100, error_rate=0.003, seed=seed + 1)
    codes, lengths = dna.encode_reads(r1 + r2)
    quals = np.frombuffer("".join(q1 + q2).encode(), np.uint8).reshape(
        codes.shape).copy()
    return codes, lengths, quals


@pytest.mark.cuda
@pytest.mark.parametrize("with_quals", [True, False])
def test_correct_reads_card_equals_cpu(card, with_quals):
    codes, lengths, quals = _reads_with_quals(20_000, 8)
    out = {}
    for dev in (card, torch.device("cpu")):
        before = kmer_cuda.extract_sort_keys.launches
        fixed, stats = correct.correct_reads(
            torch.from_numpy(codes), torch.from_numpy(lengths),
            quals=torch.from_numpy(quals) if with_quals else None,
            device=dev)
        assert fixed.device.type == dev.type
        launched = kmer_cuda.extract_sort_keys.launches - before
        assert launched > 0 if dev.type == "cuda" else launched == 0
        out[dev.type] = (fixed.cpu(), stats)
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert out["cuda"][1] == out["cpu"][1]
    assert out["cuda"][1]["changed_bases"] > 0


@pytest.mark.cuda
def test_correct_reads_ion_card_equals_cpu(card):
    codes, lengths, _ = _reads_with_quals(10_000, 4)
    a = ionhammer.correct_reads_ion(codes, lengths, device=card)
    b = ionhammer.correct_reads_ion(codes, lengths, device="cpu")
    assert torch.equal(a[0].cpu(), b[0]) and torch.equal(a[1].cpu(), b[1])
    assert a[2] == b[2]


def _paired_graph(size, seed):
    """A k = 33 graph of a simulation (assembled on the CPU) and its 100 bp
    pairs (insert 300): (graph, codes1, lengths1, codes2, lengths2)."""
    genome = simulate.random_genome(size, seed=seed, repeats=[(400, 2)])
    r1, _, r2, _ = simulate.simulate_paired_reads(
        genome, size // 5, read_len=100, error_rate=0.002, seed=seed + 1)
    codes, lengths = dna.encode_reads(r1 + r2)
    g = assemble.assemble_single_k(codes, lengths, 33, device="cpu").graph
    return (g, *dna.encode_reads(r1), *dna.encode_reads(r2))


@pytest.mark.cuda
@pytest.mark.parametrize("kp1", [34, 56])
def test_edge_index_and_mapping_card_equals_cpu(card, kp1):
    g, c1, l1, _, _ = _paired_graph(20_000, 12)
    out = {}
    for dev in (card, torch.device("cpu")):
        before = kmer_cuda.extract_sort_keys.launches
        idx = index.build_edge_index(g, kp1, device=dev)
        one = chunked.map_reads_chunked(idx, g.seq_len, c1, l1, kp1,
                                        device=dev)
        multi = chunked.map_reads_multi_chunked(idx, g.seq_len, c1, l1, kp1,
                                                min_votes=1, chunk=1000,
                                                device=dev)
        launched = kmer_cuda.extract_sort_keys.launches - before
        assert launched >= 3 if dev.type == "cuda" else launched == 0
        out[dev.type] = [t.cpu() for t in (*idx[:5], *one, *multi)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_paired_index_and_estimators_card_equals_cpu(card):
    g, c1, l1, c2, l2 = _paired_graph(20_000, 13)
    out = {}
    for dev in (card, torch.device("cpu")):
        idx = index.build_edge_index(g, 34, device=dev)
        c2rc = dna.revcomp_reads(torch.from_numpy(c2).to(dev),
                                 torch.from_numpy(l2).to(dev))
        ch = [mapper.normalize_chain(chunked.map_reads_multi_chunked(
            idx, g.seq_len, c, l, 34, min_votes=1, device=dev),
            g.conj.to(dev)) for c, l in ((c1, l1), (c2rc, l2))]
        raw = pair_info.fill_paired_index_multi_chunked(*ch, 200)
        out[dev.type] = [pair_info.host_index(x) for x in (
            raw, pair_info.cluster_distances(raw, 50),
            pair_info.cluster_distances_smoothing(raw, 20, 2.0))]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.num == b.num and a.num > 0
        for name in ("e1", "e2", "dist", "weight", "var"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None)
            if x is not None:   # exact sums: the same bits on both
                np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.cuda
def test_gap_closing_and_repeat_resolution_card_equals_cpu(card):
    g, c1, l1, c2, l2 = _paired_graph(20_000, 14)
    out = {}
    for dev in (card, torch.device("cpu")):
        g2, joined = gap_closer.close_gaps(g, c1, l1, c2, l2, device=dev)
        assert g2.device.type == dev.type
        paths, lib_data = {}, []
        contigs, scaffolds = assemble.repeat_resolution_multi(
            g2, [(c1, l1, c2, l2, "pe")], with_scaffolds=True,
            lib_data_out=lib_data, paths_out=paths, device=dev)
        out[dev.type] = (joined, contigs, scaffolds, paths, lib_data)
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][4][0]["pairs_used"] > 0


def _planted(g, n_errors, seed):
    """``g`` with ``n_errors`` bases changed mid-edge, mirrored on the
    conjugate edges (two slots each)."""
    rng = np.random.default_rng(seed)
    flat = g.seq_flat.clone()
    alive = np.nonzero(g.alive.numpy())[0]
    ids = [int(e) for e in alive if int(g.seq_len[e]) > 600
           and int(g.conj[e]) > e][:n_errors]
    for e in ids:
        s, ln = int(g.seq_start[e]), int(g.seq_len[e])
        p = int(rng.integers(200, ln - 200))
        flat[s + p] = (flat[s + p] + 1) % 4
        cs = int(g.seq_start[int(g.conj[e])])
        flat[cs + ln - 1 - p] = 3 - flat[s + p]
    return g._replace(seq_flat=flat), 2 * len(ids)


@pytest.mark.cuda
def test_mismatch_correction_card_equals_cpu(card):
    g, c1, l1, c2, l2 = _paired_graph(20_000, 15)
    bad, planted = _planted(g, 3, 16)
    codes = np.concatenate([c1, c2])
    lengths = np.concatenate([l1, l2])
    out = {}
    for dev in (card, torch.device("cpu")):
        before = kmer_cuda.extract_sort_keys.launches
        fixed, n = mismatch_correction.correct_mismatches(
            bad, codes, lengths, chunk=5000, device=dev)
        launched = kmer_cuda.extract_sort_keys.launches - before
        assert launched >= 2 if dev.type == "cuda" else launched == 0
        out[dev.type] = (fixed.seq_flat.cpu(), n)
    assert out["cuda"][1] == out["cpu"][1] >= planted > 0
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cpu"][0], g.seq_flat)


@pytest.mark.cuda
def test_restricted_assembly_card_equals_cpu(card):
    # tests/test_torch_restricted.py::_allele_reads: a 10 kb genome at
    # 30x, 2 kb of it with four SNPs at 15x
    genome = simulate.random_genome(10_000, seed=91)
    variant = list(genome[4000:6000])
    for p in (400, 800, 1200, 1600):
        variant[p] = "ACGT"[("ACGT".index(variant[p]) + 1) % 4]
    variant = "".join(variant)
    r1, _, r2, _ = simulate.simulate_paired_reads(
        genome, 1500, read_len=100, error_rate=0.001, seed=92)
    v1, _, v2, _ = simulate.simulate_paired_reads(
        variant, 150, read_len=100, error_rate=0.001, seed=93)
    codes, lengths = dna.encode_reads(r1 + r2 + v1 + v2)
    windows = [variant[p - 21:p + 22] for p in (400, 800, 1200, 1600)]
    out = {}
    for dev in (card, torch.device("cpu")):
        res = assemble.assemble_single_k(codes, lengths, 21,
                                         restricted_sequences=windows,
                                         device=dev)
        out[dev.type] = sorted((min(s, dna.revcomp_str(s)), c)
                               for s, c in res.contigs)
    assert [s for s, _ in out["cuda"]] == [s for s, _ in out["cpu"]]
    np.testing.assert_allclose([c for _, c in out["cuda"]],
                               [c for _, c in out["cpu"]], rtol=1e-4)
    seqs = [s for s, _ in out["cuda"]]
    assert all(any(w in s or dna.revcomp_str(w) in s for s in seqs)
               for w in windows)


@pytest.mark.cuda
def test_gfa_input_card_equals_cpu(card, tmp_path):
    g, c1, l1, c2, l2 = _paired_graph(20_000, 20)
    path = str(tmp_path / "g.gfa")
    gfa.write_gfa(path, g)
    out = {}
    for dev in (card, torch.device("cpu")):
        loaded = from_gfa.graph_from_gfa(path, device=dev)
        assert loaded.device.type == dev.type
        g2, joined = gap_closer.close_gaps(loaded, c1, l1, c2, l2,
                                           device=dev)
        contigs, scaffolds = assemble.repeat_resolution_multi(
            g2, [(c1, l1, c2, l2, "pe")], with_scaffolds=True, device=dev)
        out[dev.type] = (joined, contigs, scaffolds)
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
def test_sc_assembly_card_equals_cpu(card):
    genome = simulate.random_genome(20_000, seed=21, repeats=[(400, 2)])
    rng = np.random.default_rng(22)
    reads = []
    for lo in range(0, 20_000, 5000):   # coverage constant over 5 kb blocks
        block = genome[lo:lo + 5000]
        cov = float(np.clip(40 * np.exp(0.8 * rng.standard_normal()), 8,
                            200))
        for _ in range(int(cov * len(block) / 100)):
            p = int(rng.integers(0, len(block) - 100))
            reads.append(block[p:p + 100])
    codes, lengths = dna.encode_reads(reads)
    cfg = config.config_for_mode("sc").simplify
    out = {}
    for dev in (card, torch.device("cpu")):
        res = assemble.assemble_single_k(codes, lengths, 33, cfg=cfg,
                                         uneven_depth=True, device=dev)
        out[dev.type] = (res.genomic_info.ec_bound, sorted(
            (min(s, dna.revcomp_str(s)), c) for s, c in res.contigs))
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    assert [s for s, _ in out["cuda"][1]] == [s for s, _ in out["cpu"][1]]
    np.testing.assert_allclose([c for _, c in out["cuda"][1]],
                               [c for _, c in out["cpu"][1]], rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("band", [0, 1, 4, 15, 16, 48, 511])
def test_banded_ed_kernel_equals_plain(card, band):
    """The hand kernel csrc/banded_ed.cu bit-equal to its plain version:
    similar and unrelated pairs, lengths 0 and 1, length differences in
    and past the band; one slot a lane up to band 15, then 2-32."""
    from spades_for_blackbird_tpu_torch.ops import align
    rng = np.random.default_rng(band)
    B, L = 40, 700
    a = rng.integers(0, 4, (B, L)).astype(np.uint8)
    b = np.where(rng.random((B, L)) < 0.1, rng.integers(0, 5, (B, L)),
                 a).astype(np.uint8)
    a_len = rng.integers(0, L + 1, B).astype(np.int32)
    b_len = np.clip(a_len + rng.integers(-2 * band - 2, 2 * band + 3, B),
                    0, L).astype(np.int32)
    a_len[:2], b_len[:2] = (0, 1), (1, 0)
    kernel = align.BandedEditDistanceKernel()
    args = [torch.from_numpy(x).to(card) for x in (a, a_len, b, b_len)]
    got = kernel(*args, band)
    want = align.banded_edit_distance_plain(*args, band)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [20, 37, 120, 300, 512, 513, 1100, 2048,
                               2049, 5000])
def test_viterbi_kernel_equals_plain(card, m):
    """The hand kernel csrc/viterbi.cu bit-equal to its plain version at
    every position within a row's length, one profile on a padded array:
    the warp path (m <= 512, 2-16 nodes a lane), the block path (one
    node a thread, and two) and the tile path (m > 2,048: node tiles)."""
    from spades_for_blackbird_tpu_torch.ops import hmm
    rng = np.random.default_rng(m)
    cons = rng.integers(0, 20, m)
    B, L = 6, 2 * m + 50
    seqs = rng.integers(0, 21, (B, L)).astype(np.uint8)
    seqs[:, 20:20 + m] = cons
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:2] = (0, L)
    kernel = hmm.ViterbiKernel()
    args = hmm.profile_tensors(hmm.hmm_from_consensus("c", cons), card)
    s, ln = (torch.from_numpy(x).to(card) for x in (seqs, lengths))
    es, st = kernel(*args, s, ln, m)
    pes, pst = hmm.viterbi_ends_plain(*args, s, ln, m)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    inside = torch.arange(L, device=card)[None, :] < ln[:, None]
    assert torch.equal(torch.where(inside, es, 0), torch.where(inside, pes, 0))
    assert torch.equal(torch.where(inside, st, 0), torch.where(inside, pst, 0))
    assert bool((es[~inside] == hmm.NEG).all()) and bool(
        (st[~inside] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("ms,lengths", [
    ((20, 120, 300, 512, 513, 1100, 2048), (0, 1, 600, 37, 2, 451, 129)),
    ((37, 300, 1100), (0, 1, 20_000, 500, 3))])
def test_viterbi_batched_kernel_equals_plain(card, ms, lengths):
    """Profiles of mixed m (both paths) over ragged rows in one entry
    call, the buffer a view at an odd address: bit-equal to the plain
    batched version everywhere, rows of 0, 1 and 20,000 positions."""
    from spades_for_blackbird_tpu_torch.ops import hmm
    rng = np.random.default_rng(len(ms))
    profs = [hmm.hmm_from_consensus(f"c{m}", rng.integers(0, 20, m))
             for m in ms]
    lengths = np.asarray(lengths, np.int32)
    flat = rng.integers(0, 21, int(lengths.sum()) + 1).astype(np.uint8)
    offsets = (np.cumsum(lengths) - lengths).astype(np.int64)
    for prof, o in zip(profs, offsets[2:]):
        cons = prof.match[:, :20].argmax(1)
        flat[1 + o:1 + o + len(cons)] = cons[:len(flat) - 1 - o]
    seqs = torch.from_numpy(flat).to(card)[1:]
    row_off, row_len = (torch.from_numpy(x).to(card)
                        for x in (offsets, lengths))
    kernel = hmm.ViterbiKernel()
    pack = hmm.pack_profiles(profs, card)
    es, st = kernel.batched(pack, seqs, row_off, row_len)
    pes, pst = hmm.viterbi_batched_plain(pack, seqs, row_off, row_len)
    torch.cuda.synchronize()
    assert kernel.launches == 2  # the warp and the block kernel
    assert torch.equal(es.view(torch.int32), pes.view(torch.int32))
    assert torch.equal(st, pst)



@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cols", [1, 21])
def test_seg_sum_kernel_equals_plain(card, dtype, cols):
    """The ordered float sum on the card equals the CPU's ``index_add_``
    bit for bit, five calls in a row, with most rows on three slots and
    magnitudes from 2^-60 to 2^60."""
    from spades_for_blackbird_tpu_torch.ops import segments, seg_sum
    rng = np.random.default_rng(cols)
    n, M = 5000, 400_000
    idx = rng.integers(0, n + 1, M)
    hot = rng.random(M) < 0.7
    idx[hot] = rng.integers(0, 3, hot.sum())
    vals = rng.standard_normal((M, cols)) * np.exp2(
        rng.integers(-60, 60, (M, cols)))
    idx_t = torch.from_numpy(idx)
    vals_t = torch.from_numpy(vals).to(dtype)
    want = torch.zeros((n + 1, cols), dtype=dtype).index_add_(
        0, idx_t, vals_t)[:n]
    before = seg_sum.seg_sum.launches
    for _ in range(5):
        got = segments.index_add_float(
            torch.zeros((n + 1, cols), dtype=dtype, device=card),
            idx_t.to(card), vals_t.to(card), limit=n)[:n].cpu()
        assert torch.equal(got, want)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert seg_sum.seg_sum.launches == before + 5


def _run_length_rows(rng, case):
    """(index, values, limit) of a scatter whose runs have the lengths
    of ``case``, in a shuffled row order."""
    if case == "single run":
        n, lens, cols = 10, np.asarray([1_100_000]), 1
    elif case == "long runs":
        n, cols = 200, 1
        lens = np.concatenate([np.full(3, 300_000), rng.integers(1, 9000,
                                                                 197)])
    else:  # mixed lengths, C = 21
        n, cols = 6_000, 21
        lens = np.concatenate([rng.integers(1, 9, 5_000),
                               rng.integers(50, 500, 900),
                               rng.integers(1_000, 5_000, 100)])
    slots = rng.permutation(n)[:len(lens)]
    idx = np.repeat(slots, lens)
    idx[rng.random(len(idx)) < 0.05] = n
    idx = idx[rng.permutation(len(idx))]
    vals = rng.standard_normal((len(idx), cols)) * np.exp2(
        rng.integers(-60, 60, (len(idx), cols)))
    return torch.from_numpy(idx), torch.from_numpy(vals), n


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["single run", "long runs",
                                  "mixed lengths, C = 21"])
def test_seg_sum_kernel_equals_plain_by_run_length(card, case):
    """The kernel (tiles of short runs, a block a long run) bit-equal to
    its plain version on one run of 1.1 million rows, runs past a tile
    beside short ones, and mixed lengths at C = 21, with int32 and int64
    slots, reading through the permutation and on rows copied out; the
    route equals the CPU's ``index_add_`` in three calls."""
    from spades_for_blackbird_tpu_torch.ops import segments, seg_sum
    rng = np.random.default_rng(len(case))
    idx, vals, n = _run_length_rows(rng, case)
    cols = vals.shape[1]
    slot, perm = segments.sorted_slots(idx.to(card), n)
    assert slot.dtype == torch.int32
    out = torch.zeros((n + 1, cols), dtype=torch.float32, device=card)
    v = vals.to(torch.float32).to(card)
    want = seg_sum.seg_sum_plain(out.cpu(), slot.cpu(), v.cpu(), perm.cpu(),
                                 n)
    kernel = seg_sum.SegSumKernel()
    for keys in (slot, slot.to(torch.int64)):
        for got in (kernel(out.clone(), keys, v, perm=perm, limit=n),
                    kernel(out.clone(), keys, v[perm], limit=n)):
            assert torch.equal(got.cpu().view(torch.int32),
                               want.view(torch.int32))
    assert kernel.launches == 4
    cpu = torch.zeros((n + 1, cols)).index_add_(0, idx, vals.float())
    for _ in range(3):
        route = segments.index_add_float(out.clone(), idx.to(card), v,
                                         limit=n)
        assert torch.equal(route[:n].cpu().view(torch.int32),
                           cpu[:n].view(torch.int32))


@pytest.mark.cuda
def test_tools_card_equals_cpu(card, tmp_path):
    """gbuilder, kmercount and kmer-estimating on the card and on the
    CPU: the same files and the same estimate."""
    from spades_for_blackbird_tpu_torch import tools
    genome = simulate.random_genome(20_000, seed=5, repeats=[(300, 2)])
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, 3000, read_len=100, error_rate=0.002, seed=6)
    fq = str(tmp_path / "r.fq")
    simulate.write_fastq(fq, r1 + r2, q1 + q2)
    outs = {}
    for dev in ("cuda", "cpu"):
        d = tmp_path / dev
        d.mkdir()
        assert tools.main(["gbuilder", fq, "-k", "33", "--gfa",
                           str(d / "g.gfa"), "--device", dev]) == 0
        assert tools.main(["kmercount", fq, "-k", "21", "-o",
                           str(d / "c.tsv"), "--device", dev]) == 0
        outs[dev] = [(d / n).read_bytes() for n in ("g.gfa", "c.tsv")]
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.cuda
def test_sharded_counter_and_hammer_world1_nccl(card, tmp_path):
    """A world-1 NCCL group on the card: the sharded (k+1)-mer counter
    and the sharded corrector give the single-device path's bits."""
    import datetime

    import torch.distributed as dist
    from spades_for_blackbird_tpu_torch.parallel import (
        hammer_dist, kmer_exchange, mesh as mesh_mod)

    genome = simulate.random_genome(3000, seed=23)
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, 500, read_len=60, insert_mean=150.0, insert_sd=10.0,
        error_rate=0.01, seed=24)
    codes, lengths = dna.encode_reads(r1 + r2)
    quals = np.stack([np.frombuffer(q.encode(), np.uint8) for q in q1 + q2])
    c = torch.from_numpy(codes).to(card)
    ln = torch.from_numpy(lengths).to(card)
    q = torch.from_numpy(quals).to(card)
    want_t = counter.trim_table(counter.count_kmers_chunked(c, ln, 22))
    want_c, want_s = correct.correct_reads(c, ln, quals=q, device=card)
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'init'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = mesh_mod.make_mesh()
        got_t = kmer_exchange.make_sharded_counter(mesh, 22)(c, ln)
        got_c, got_s = hammer_dist.make_sharded_hammer(mesh, 21)(c, ln, q)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    n = int(want_t.num)
    assert int(got_t.num) == n
    assert torch.equal(got_t.kmers[:n], want_t.kmers[:n])
    assert torch.equal(got_t.counts[:n], want_t.counts[:n])
    assert torch.equal(got_c, want_c)
    assert got_s == want_s
