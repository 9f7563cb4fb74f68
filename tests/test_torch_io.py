"""The PyTorch port's host I/O vs the JAX package: read parsing (native
reader and Python parser), the read store, and the graph writers."""

import gzip

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from spades_for_blackbird_tpu.graph.graph import Graph as JGraph  # noqa: E402
from spades_for_blackbird_tpu.io import fastg as jfastg  # noqa: E402
from spades_for_blackbird_tpu.io import fastq as jfastq  # noqa: E402
from spades_for_blackbird_tpu.io import gfa as jgfa  # noqa: E402
from spades_for_blackbird_tpu.ops import dna as jdna  # noqa: E402
from spades_for_blackbird_tpu_torch import interop, native  # noqa: E402
from spades_for_blackbird_tpu_torch.io import (  # noqa: E402
    fastg, fastq, gfa, read_store)
from spades_for_blackbird_tpu_torch.kmers import counter  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import assemble  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402


def _ragged_reads(seed, R=37, L=50):
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(R):
        n = int(rng.integers(1, L + 1))
        s = rng.choice(list("ACGTN"), size=n, p=[.24, .24, .24, .24, .04])
        reads.append("".join(s))
    return reads


def test_revcomp_reads_matches_jax():
    codes, lengths = dna.encode_reads(_ragged_reads(1) + ["", "ACGTN"])
    ours = dna.revcomp_reads(torch.from_numpy(codes),
                             torch.from_numpy(lengths))
    theirs = jdna.revcomp_reads(jnp.asarray(codes), jnp.asarray(lengths))
    assert ours.dtype == torch.uint8
    assert np.array_equal(ours.numpy(), np.asarray(theirs))
    # a read's reverse complement as strings
    for i in (0, 5, len(lengths) - 1):
        n = int(lengths[i])
        assert dna.decode_codes(ours[i, :n].numpy()) == dna.revcomp_str(
            dna.decode_codes(codes[i, :n]))
        assert (ours[i, n:] == dna.INVALID_CODE).all()
    comp = dna.complement_codes(torch.from_numpy(codes))
    assert np.array_equal(comp.numpy(),
                          np.asarray(jdna.complement_codes(
                              jnp.asarray(codes))))


def _write(path, text):
    if str(path).endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return str(path)


def _fastq_text(reads, tag="r"):
    rng = np.random.default_rng(len(reads))
    out = []
    for i, r in enumerate(reads):
        q = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, len(r)))
        out.append(f"@{tag}{i} desc\n{r}\n+\n{q}\n")
    return "".join(out)


def _fasta_text(reads, width=17):
    out = []
    for i, r in enumerate(reads):
        out.append(f">s{i} something\n")
        out.extend(r[j:j + width] + "\n" for j in range(0, len(r), width))
    return "".join(out)


@pytest.fixture(params=["native", "python"])
def reader(request, monkeypatch):
    """Both readers of the port: the C++ one, and the Python parser that a
    machine without g++ takes."""
    if request.param == "python":
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
    elif native.get_lib() is None:
        pytest.skip("no g++ or zlib here: the native reader cannot be built")
    return request.param


def _assert_batches_equal(ours, theirs):
    assert ours.codes.dtype == np.uint8 and ours.lengths.dtype == np.int32
    assert np.array_equal(ours.codes, theirs.codes)
    assert np.array_equal(ours.lengths, theirs.lengths)
    assert (ours.quals is None) == (theirs.quals is None)
    if ours.quals is not None:
        assert np.array_equal(ours.quals, theirs.quals)
    assert ours.names == theirs.names


@pytest.mark.parametrize("name", ["r.fastq", "r.fastq.gz", "r.fasta",
                                  "r.fasta.gz"])
@pytest.mark.parametrize("with_quals", [False, True])
def test_load_reads_matches_jax(tmp_path, reader, name, with_quals):
    reads = [r for r in _ragged_reads(3) if r]
    text = _fastq_text(reads) if "fastq" in name else _fasta_text(reads)
    path = _write(tmp_path / name, text)
    ours = fastq.load_reads(path, with_quals=with_quals)
    theirs = jfastq.load_reads(path, with_quals=with_quals)
    _assert_batches_equal(ours, theirs)
    assert ours.num_reads == len(reads)
    assert [dna.decode_codes(c[:n]) for c, n in
            zip(ours.codes, ours.lengths)] == reads
    assert (ours.quals is not None) == (with_quals and "fastq" in name)
    assert fastq.peek_read_length(path) == jfastq.peek_read_length(path) \
        == max(len(r) for r in reads)
    assert fastq.read_sequences(path) == jfastq.read_sequences(path)


def test_load_reads_names_and_max_len(tmp_path):
    reads = [r for r in _ragged_reads(4) if r]
    path = _write(tmp_path / "r.fq", _fastq_text(reads))
    for kw in ({"keep_names": True}, {"max_len": 20},
               {"max_len": 20, "with_quals": True}):
        _assert_batches_equal(fastq.load_reads(path, **kw),
                              jfastq.load_reads(path, **kw))
    empty = _write(tmp_path / "empty.fq", "")
    assert fastq.peek_read_length(empty) == 0
    with pytest.raises(ValueError):
        fastq.read_sequences(_write(tmp_path / "bad.txt", "hello\n"))


def test_paired_reads_and_concat_match_jax(tmp_path, reader):
    left = [r for r in _ragged_reads(5, L=40) if r]
    right = [r for r in _ragged_reads(6, R=len(left), L=55)][:len(left)]
    right = [r or "A" for r in right]
    p1 = _write(tmp_path / "a_1.fq.gz", _fastq_text(left))
    p2 = _write(tmp_path / "a_2.fq", _fastq_text(right))
    ours = fastq.load_paired_reads(p1, p2, with_quals=True)
    theirs = jfastq.load_paired_reads(p1, p2, with_quals=True)
    for o, t in zip(ours, theirs):
        _assert_batches_equal(o, t)
    assert ours[0].max_len == ours[1].max_len
    single = fastq.load_reads(_write(tmp_path / "s.fa", _fasta_text(left)))
    jsingle = jfastq.load_reads(str(tmp_path / "s.fa"))
    _assert_batches_equal(fastq.concat_batches(list(ours)),
                          jfastq.concat_batches(list(theirs)))
    # one batch without qualities drops them from the whole
    both = fastq.concat_batches([ours[0], single])
    _assert_batches_equal(both, jfastq.concat_batches([theirs[0], jsingle]))
    assert both.quals is None
    short = _write(tmp_path / "short.fq", _fastq_text(right[:3]))
    with pytest.raises(ValueError, match="paired files disagree"):
        fastq.load_paired_reads(p1, short)


@pytest.mark.parametrize("name", ["w.fastq", "w.fastq.gz"])
def test_write_reads_fastq_round_trip(tmp_path, name):
    codes, lengths = dna.encode_reads(_ragged_reads(7))
    path = str(tmp_path / name)
    fastq.write_reads_fastq(path, codes, lengths, prefix="x")
    jpath = str(tmp_path / ("j" + name))
    jfastq.write_reads_fastq(jpath, codes, lengths, prefix="x")
    opener = gzip.open if name.endswith(".gz") else open
    with opener(path, "rb") as a, opener(jpath, "rb") as b:
        assert a.read() == b.read()
    back = fastq.load_reads(path, with_quals=True)
    assert np.array_equal(back.lengths, lengths)
    assert np.array_equal(back.codes, codes[:, :back.max_len])
    assert set(np.unique(back.quals)) <= {0, ord("I")}


def test_native_library_builds_into_the_build_directory():
    if native.get_lib() is None:
        pytest.skip("no g++ or zlib here: the native reader cannot be built")
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR) and path.endswith(".so")
    import os
    assert os.path.exists(path)
    assert os.path.basename(native.BUILD_DIR) == "build"


# ---- read store ----

def _store_reads():
    rng = np.random.default_rng(2)
    genome = "".join(rng.choice(list("ACGT"), size=500))
    return ([genome[i:i + 70] for i in range(0, 430, 2)]
            + [genome[i:i + 45] for i in range(0, 255, 5)])


def test_read_store_round_trip_and_python_parity(tmp_path, reader):
    reads = _store_reads()
    p1 = _write(tmp_path / "a.fastq.gz", _fastq_text(reads[:100]))
    p2 = _write(tmp_path / "b.fasta", _fasta_text(reads[100:], width=80))
    sp = str(tmp_path / "reads.store")
    store = read_store.ReadStore.convert([p1, p2], sp, chunk_reads=32)
    assert store.num_reads == len(reads)
    assert store.max_len == 70
    assert store.num_chunks == -(-len(reads) // 32)
    got = []
    for ci in range(store.num_chunks):
        codes, lengths = store.load_chunk(ci)
        assert codes.shape == (32, 70)
        for r in range(32):
            if ci * 32 + r >= store.num_reads:
                assert lengths[r] == 0
                continue
            got.append(dna.decode_codes(codes[r, :lengths[r]]))
    assert got == reads
    # the NumPy writer and reader give the same bytes and arrays
    sp_py = str(tmp_path / "py.store")
    read_store.ReadStore._convert_py([p1, p2], sp_py, 32)
    with open(sp, "rb") as a, open(sp_py, "rb") as b:
        assert a.read() == b.read()
    c1, l1 = store.load_chunk(1)
    c2, l2 = store._load_chunk_py(1, np.full_like(c1, 4), np.zeros_like(l1))
    assert np.array_equal(c1, c2) and np.array_equal(l1, l2)
    with pytest.raises(ValueError, match="not a read store"):
        read_store.ReadStore(p2)


def test_read_store_reads_the_reference_store(tmp_path):
    """One format: a store written by the JAX package opens in the port."""
    from spades_for_blackbird_tpu.io import read_store as jread_store
    reads = _store_reads()[:50]
    p = _write(tmp_path / "r.fq", _fastq_text(reads))
    jread_store.ReadStore.convert([p], str(tmp_path / "j.store"),
                                  chunk_reads=16)
    read_store.ReadStore.convert([p], str(tmp_path / "t.store"),
                                 chunk_reads=16)
    with open(tmp_path / "j.store", "rb") as a, \
            open(tmp_path / "t.store", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("k", [15, 34])
def test_count_kmers_store_matches_in_memory(tmp_path, k):
    reads = _store_reads()
    p = _write(tmp_path / "r.fastq.gz", _fastq_text(reads))
    store = read_store.ReadStore.convert([p], str(tmp_path / "r.store"),
                                         chunk_reads=32)
    assert store.num_chunks > 3
    t = read_store.count_kmers_store(store, k, device="cpu")
    codes, lengths = dna.encode_reads(reads)
    want = counter.count_kmers(torch.from_numpy(codes),
                               torch.from_numpy(lengths), k)
    n = int(t.num)
    assert n == int(want.num)
    assert torch.equal(t.kmers[:n], want.kmers[:n])
    assert torch.equal(t.counts[:n], want.counts[:n])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            read_store.count_kmers_store(store, k)


# ---- graph writers ----

@pytest.fixture(scope="module")
def graphs():
    """A simplified graph of the port with branches left in it, and the
    same graph in the JAX package's structure."""
    genome = simulate.random_genome(4000, seed=3, repeats=[(200, 3)])
    r1, _, r2, _ = simulate.simulate_paired_reads(
        genome, 1000, read_len=60, insert_mean=200, insert_sd=15,
        error_rate=0.002, seed=4)
    codes, lengths = dna.encode_reads(r1 + r2)
    g = assemble.assemble_single_k(codes, lengths, 21, device="cpu").graph
    arrays = interop.graph_to_saved_arrays(g)
    jg = JGraph(**{name: jnp.asarray(arrays[name])
                   for name in interop.GRAPH_FIELDS if name in arrays},
                k=g.k)
    return g, jg


def _paths(g):
    """Named (edge, gap) chains over the graph: single edges, a chain of
    adjacent edges, and one with a gap."""
    h = gfa.host_fields(g, "start_v", "end_v")
    alive = np.nonzero(h["alive"])[0]
    by_start = {}
    for e in alive:
        by_start.setdefault(int(h["start_v"][e]), []).append(int(e))
    chains = [[(int(alive[0]), 0)]]
    for e in alive:
        nxt = by_start.get(int(h["end_v"][e]))
        if nxt:
            chains.append([(int(e), 0), (nxt[0], 0)])
            chains.append([(int(e), 0), (nxt[0], 0), (int(alive[-1]), 25)])
            break
    return [(f"NODE_{i}_length_1_cov_1.000000", c)
            for i, c in enumerate(chains, start=1)]


def test_graph_writers_are_byte_identical(tmp_path, graphs):
    g, jg = graphs
    paths = _paths(g)
    assert len(paths) == 3, "the fixture graph has no adjacent edges"
    for name, ours, theirs in (
            ("g.gfa", lambda p: gfa.write_gfa(p, g, paths=paths),
             lambda p: jgfa.write_gfa(p, jg, paths=paths)),
            ("bare.gfa", lambda p: gfa.write_gfa(p, g),
             lambda p: jgfa.write_gfa(p, jg)),
            ("g.fastg", lambda p: fastg.write_fastg(p, g),
             lambda p: jfastg.write_fastg(p, jg)),
            ("g.paths", lambda p: gfa.write_paths_file(p, g, paths),
             lambda p: jgfa.write_paths_file(p, jg, paths))):
        ours(str(tmp_path / name))
        theirs(str(tmp_path / ("j_" + name)))
        a = (tmp_path / name).read_bytes()
        assert a and a == (tmp_path / ("j_" + name)).read_bytes(), name

    segments, links, plines = gfa.read_gfa(str(tmp_path / "g.gfa"),
                                           with_paths=True)
    assert (segments, links, plines) == jgfa.read_gfa(
        str(tmp_path / "g.gfa"), with_paths=True)
    segs, seg_of, alive, conj = gfa.segment_naming(g)
    assert len(segments) == len(segs) > 1 and links
    assert len(plines) >= 3  # the gapped chain splits into two records
    seqs = {s for s, _ in segments.values()}
    for s, _ in assemble.fasta.graph_contigs(g):
        assert s in seqs or dna.revcomp_str(s) in seqs
    jsegs, jseg_of, _, _ = jgfa.segment_naming(jg)
    assert segs == jsegs and seg_of == jseg_of
    chain = paths[-1][1]
    assert gfa.conjugate_chain(g, chain) == jgfa.conjugate_chain(jg, chain)
