"""The PyTorch port's HMM modes vs the JAX package's: translation, the
profile-HMM Viterbi and hit selection, the HMMER3 file reader and
writer, domain extraction, the domain graph and the BGC files, and
``-1/-2 --bio --custom-hmms`` and ``--corona --custom-hmms`` through
both command lines.

Inputs are made from numpy seeds. Viterbi end scores are held at rtol
1e-5 / atol 1e-3, since XLA's ``cumsum`` of the delete transitions may
add in another order than the port's (host, in order); end starts and
hits must be equal within each row's length. Every other result must be
identical, the command lines' files byte for byte.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))

import naive_debruijn as nd  # noqa: E402
import test_bio_hmm as jfix  # noqa: E402
from spades_for_blackbird_tpu import cli as jcli  # noqa: E402
from spades_for_blackbird_tpu.io import hmmfile as jhmmfile  # noqa: E402
from spades_for_blackbird_tpu.models import bio as jbio  # noqa: E402
from spades_for_blackbird_tpu.ops import aa as jaa  # noqa: E402
from spades_for_blackbird_tpu.ops import hmm as jhmm  # noqa: E402
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import cli, interop  # noqa: E402
from spades_for_blackbird_tpu_torch.io import hmmfile  # noqa: E402
from spades_for_blackbird_tpu_torch.models import bio  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import aa, hmm  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

CPU = ["--device", "cpu"]
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-3  # XLA's cumsum order
# two domains of 48 aa (random, fixed)
MOTIFS = ("CSPNSFVHYHIIHTECWIFSRSRPYDSIQVLYFRDEAVEELHGIHIPD",
          "MENSHCYILAYLRCIAQTHFCTWGKTKKTQRYTFPPDCRLYEQSADHK")
# what the HMM command lines write besides the isolate's files
BIO_OUTPUTS = ("gene_clusters.fasta", "bgc_statistics.txt",
               "domain_graph.dot")
OUTPUTS = ("contigs.fasta", "scaffolds.fasta", "before_rr.fasta",
           "assembly_graph_with_scaffolds.gfa", "assembly_graph.fastg",
           "contigs.paths", "scaffolds.paths", "final.lib_data",
           "scaffold_graph.scg", "scaffold_graph.dot") + BIO_OUTPUTS


@pytest.fixture(autouse=True)
def _reference_logger_reset(monkeypatch):
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    jlogger.configure()
    yield
    # the JAX command line leaves a writer on its closed log file
    jlogger.configure()


def _random_profile(rng, m):
    """A profile with random emissions and transitions (some '*' = NEG),
    in both packages."""
    match = rng.normal(0.0, 1.5, (m, 21)).astype(np.float32)
    match[:, 20] = hmm.NEG
    match[rng.random((m, 21)) < 0.02] = hmm.NEG
    arrays = {"match": match}
    for name in ("tMM", "tMI", "tMD", "tIM", "tII", "tDM", "tDD"):
        arrays[name] = np.log(rng.uniform(0.02, 0.98, m)).astype(np.float32)
    arrays["tDD"][-1] = hmm.NEG
    return (interop.hmm_profile_from_numpy("r", arrays),
            jhmm.HMMProfile(name="r", **arrays))


def _rows(rng, profile_codes, B, L):
    """AA rows with planted (mutated) copies of the consensus, ragged
    lengths (0 and 1 included) and stop codons."""
    seqs = rng.integers(0, 21, (B, L)).astype(np.uint8)
    m = len(profile_codes)
    for b in range(B):
        at = int(rng.integers(0, max(1, L - m)))
        copy = np.asarray(profile_codes, np.uint8).copy()
        mut = rng.random(m) < 0.1
        copy[mut] = rng.integers(0, 20, int(mut.sum()))
        seqs[b, at:at + m] = copy[:L - at]
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:3] = (0, 1, L)
    return seqs, lengths


def _assert_ends_match(es, st, jes, jst, lengths):
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(es[b, :n], jes[b, :n], rtol=SCORE_RTOL,
                                   atol=SCORE_ATOL)
        assert np.array_equal(st[b, :n], jst[b, :n]), b


def _assert_hits_match(hits, jhits):
    """Equal intervals; scores within the stated tolerance."""
    assert [h[:2] for h in hits] == [h[:2] for h in jhits]
    np.testing.assert_allclose([h[2] for h in hits], [h[2] for h in jhits],
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("m,L,kind", [(20, 90, "consensus"),
                                      (57, 160, "consensus"),
                                      (33, 120, "random")])
def test_viterbi_ends_matches_jax(m, L, kind):
    rng = np.random.default_rng(m)
    cons = rng.integers(0, 20, m)
    if kind == "consensus":
        prof = hmm.hmm_from_consensus("c", cons)
        jprof = jhmm.hmm_from_consensus("c", cons)
    else:
        prof, jprof = _random_profile(rng, m)
    for f in interop.HMM_FIELDS:
        assert np.array_equal(getattr(prof, f), getattr(jprof, f)), f
    seqs, lengths = _rows(rng, cons, 7, L)
    jes, jst = jhmm.score_batch(jprof, seqs, lengths)
    es, st = hmm.score_batch(prof, seqs, lengths, device="cpu")
    assert es.dtype == np.float32 and st.dtype == np.int32
    _assert_ends_match(es, st, jes, jst, lengths)
    assert (es[0] == hmm.NEG).all()          # a row of length 0
    for b, n in enumerate(lengths):
        for thr, span in ((5.0, 1), (15.0, m // 10)):
            _assert_hits_match(
                hmm.find_hits(es[b], st[b], int(n), thr, span),
                jhmm.find_hits(jes[b], jst[b], int(n), thr, span))


@pytest.mark.parametrize("m", [2049, 5003])
def test_viterbi_ends_matches_jax_past_the_block_path(m):
    """Profiles longer than the block path's 2,048 nodes (on the card the
    tile path walks node tiles) take any length: the port's
    ``score_batch`` equals the JAX package's on rows of 40-120 residues
    holding slices of the consensus."""
    rng = np.random.default_rng(m)
    cons = rng.integers(0, 20, m)
    prof = hmm.hmm_from_consensus("long", cons)
    jprof = jhmm.hmm_from_consensus("long", cons)
    assert prof.length == m > hmm.BLOCK_MAX_M
    B, L = 5, 120
    seqs = rng.integers(0, 21, (B, L)).astype(np.uint8)
    for b in range(B):
        at = int(rng.integers(0, m - L))
        seqs[b, 8:L] = cons[at:at + L - 8]
    lengths = rng.integers(40, L + 1, B).astype(np.int32)
    lengths[0] = L
    jes, jst = jhmm.score_batch(jprof, seqs, lengths)
    es, st = hmm.score_batch(prof, seqs, lengths, device="cpu")
    _assert_ends_match(es, st, jes, jst, lengths)
    assert (es[0, 20:] > 20.0).all()      # the planted slice scores


def test_pack_profiles_takes_every_length():
    """``pack_profiles`` takes m = 2,049 and a batch across the warp, the
    block and the tile path; its batched call (the plain version on the
    CPU) equals each profile's ``viterbi_ends_plain``."""
    rng = np.random.default_rng(11)
    ms = (300, 512, 513, 2048, 2049)
    profs = [hmm.hmm_from_consensus(f"c{m}", rng.integers(0, 20, m))
             for m in ms]
    one = hmm.pack_profiles(profs[-1:], "cpu")
    assert one.lengths == (2049,) and one.tile_m == 2049
    assert len(one.tile_ids) == 1 and not len(one.block_ids)
    pack = hmm.pack_profiles(profs, "cpu")
    assert pack.warp_ids.tolist() == [0, 1] and pack.npl == 16
    assert pack.block_ids.tolist() == [2, 3] and pack.block_m == 2048
    assert pack.tile_ids.tolist() == [4] and pack.tile_m == 2049
    lengths = np.asarray([0, 1, 37, 64], np.int32)
    flat = rng.integers(0, 21, int(lengths.sum())).astype(np.uint8)
    offsets = (np.cumsum(lengths) - lengths).astype(np.int64)
    seqs, row_off, row_len = (torch.from_numpy(x)
                              for x in (flat, offsets, lengths))
    es, st = hmm.viterbi_kernel.batched(pack, seqs, row_off, row_len)
    padded = np.full((len(lengths), 64), aa.STOP, np.uint8)
    for b, (o, n) in enumerate(zip(offsets, lengths)):
        padded[b, :n] = flat[o:o + n]
    for p, prof in enumerate(profs):
        want_es, want_st = hmm.viterbi_ends_plain(
            *hmm.profile_tensors(prof, "cpu"), torch.from_numpy(padded),
            row_len, prof.length)
        for b, (o, n) in enumerate(zip(offsets, lengths)):
            assert torch.equal(es[p, o:o + n].view(torch.int32),
                               want_es[b, :n].view(torch.int32)), (p, b)
            assert torch.equal(st[p, o:o + n], want_st[b, :n])


def test_viterbi_signature_of_the_jax_package():
    """``viterbi_ends`` takes the JAX package's arguments (``tDD``, not
    its sum) and returns tensors; the wrapper takes the plain version on
    the CPU and launches nothing."""
    rng = np.random.default_rng(5)
    prof, jprof = _random_profile(rng, 16)
    seqs, lengths = _rows(rng, rng.integers(0, 20, 16), 4, 50)
    args = [torch.from_numpy(np.asarray(getattr(prof, f)))
            for f in interop.HMM_FIELDS]
    before = hmm.viterbi_kernel.launches
    es, st = hmm.viterbi_ends(*args, torch.from_numpy(seqs),
                              torch.from_numpy(lengths), 16)
    assert hmm.viterbi_kernel.launches == before
    jes, jst = jhmm.score_batch(jprof, seqs, lengths)
    _assert_ends_match(es.numpy(), st.numpy(), jes, jst, lengths)
    meta = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        hmm.ViterbiKernel()(*args[:7], args[7], meta,
                            torch.zeros(2, dtype=torch.int32,
                                        device="meta"), 16)


def _ragged_batch(rng, ms, lengths):
    """Profiles of lengths ``ms`` (random and consensus, in both
    packages) and ragged rows of ``lengths`` with planted copies, as one
    flat buffer with its row offsets."""
    profs, jprofs = [], []
    for k, m in enumerate(ms):
        if k % 2:
            prof, jprof = _random_profile(rng, m)
        else:
            cons = rng.integers(0, 20, m)
            prof = hmm.hmm_from_consensus(f"c{k}", cons)
            jprof = jhmm.hmm_from_consensus(f"c{k}", cons)
        profs.append(prof)
        jprofs.append(jprof)
    lengths = np.asarray(lengths, np.int32)
    seqs, _ = _rows(rng, rng.integers(0, 20, min(ms)), len(lengths),
                    int(lengths.max()))
    flat = np.concatenate([seqs[b, :n] for b, n in enumerate(lengths)])
    offsets = (np.cumsum(lengths) - lengths).astype(np.int64)
    return profs, jprofs, flat, offsets, lengths


def test_batched_viterbi_equals_each_profile_and_jax():
    """The batched call over ragged rows (the plain version, which the
    CPU takes) gives, bit for bit, ``viterbi_ends_plain`` of each profile
    on the padded rows, NEG and 0 outside every row, and the JAX
    package's ``score_batch`` within SCORE_RTOL / SCORE_ATOL."""
    rng = np.random.default_rng(9)
    lengths = [0, 1, 57, 130, 3, 88]
    profs, jprofs, flat, offsets, lengths = _ragged_batch(
        rng, (12, 41, 60), lengths)
    pack = hmm.pack_profiles(profs, "cpu")
    assert pack.lengths == (12, 41, 60) and pack.npl == 2
    seqs, row_off, row_len = (torch.from_numpy(x)
                              for x in (flat, offsets, lengths))
    before = hmm.viterbi_kernel.launches
    es, st = hmm.viterbi_kernel.batched(pack, seqs, row_off, row_len)
    assert hmm.viterbi_kernel.launches == before
    assert es.shape == st.shape == (3, len(flat))
    assert es.dtype == torch.float32 and st.dtype == torch.int32
    L = int(lengths.max())
    padded = np.full((len(lengths), L), aa.STOP, np.uint8)
    for b, (o, n) in enumerate(zip(offsets, lengths)):
        padded[b, :n] = flat[o:o + n]
    for p, (prof, jprof) in enumerate(zip(profs, jprofs)):
        want_es, want_st = hmm.viterbi_ends_plain(
            *hmm.profile_tensors(prof, "cpu"), torch.from_numpy(padded),
            row_len, prof.length)
        jes, jst = jhmm.score_batch(jprof, padded, lengths)
        got_es = np.full((len(lengths), L), hmm.NEG, np.float32)
        got_st = np.zeros((len(lengths), L), np.int32)
        for b, (o, n) in enumerate(zip(offsets, lengths)):
            got_es[b, :n] = es[p, o:o + n].numpy()
            got_st[b, :n] = st[p, o:o + n].numpy()
            assert np.array_equal(
                got_es[b, :n].view(np.int32),
                want_es[b, :n].numpy().view(np.int32)), (p, b)
            assert np.array_equal(got_st[b, :n], want_st[b, :n].numpy())
        _assert_ends_match(got_es, got_st, jes, jst, lengths)


def test_extract_domains_takes_any_profile_group(monkeypatch):
    """One batched call a profile, two, or one for all (the group size
    forced), and the default group, give the same hits."""
    profs = [hmm.hmm_from_consensus(f"m{i}", aa.encode_aa(s))
             for i, s in enumerate(MOTIFS + MOTIFS[:1])]
    contigs = _contigs()
    sized = hmm.profiles_per_launch
    runs = []
    for n in (1, 2, len(profs), None):
        monkeypatch.setattr(hmm, "profiles_per_launch",
                            sized if n is None else lambda *a, n=n: n)
        runs.append(bio.extract_domains(contigs, profs, score_threshold=15.0,
                                         device="cpu"))
    assert runs[0] and all(r == runs[0] for r in runs[1:])
    assert [h.name for h in runs[0]] == sorted(h.name for h in runs[0])


def test_translation_matches_jax():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, 301).astype(np.uint8)
    for fr in range(3):
        assert np.array_equal(aa.translate_codes(codes, fr),
                              jaa.translate_codes(codes, fr))
    assert np.array_equal(aa.CODON_LUT, jaa.CODON_LUT)
    assert aa.translate_str(jfix.reverse_translate(MOTIFS[0])) == MOTIFS[0]


def test_hmm_file_round_trip_matches_jax(tmp_path):
    """Both writers write the same file, and each reader reads the
    other's into the same arrays; the profile crosses with
    ``interop``."""
    profs = [hmm.hmm_from_consensus(f"m{i}", aa.encode_aa(s))
             for i, s in enumerate(MOTIFS)]
    jprofs = [jhmm.hmm_from_consensus(f"m{i}", jaa.encode_aa(s))
              for i, s in enumerate(MOTIFS)]
    hmmfile.write_hmm_file(str(tmp_path / "port.hmm"), profs)
    jhmmfile.write_hmm_file(str(tmp_path / "jax.hmm"), jprofs)
    assert (tmp_path / "port.hmm").read_bytes() == \
        (tmp_path / "jax.hmm").read_bytes()
    got = hmmfile.load_hmm_set(str(tmp_path))      # a directory of sets
    want = jhmmfile.read_hmm_file(str(tmp_path / "port.hmm"))
    assert [p.name for p in got] == ["m0", "m1"] * 2
    for p, q in zip(got, want * 2):
        a, b = interop.hmm_profile_to_numpy(p), \
            interop.hmm_profile_to_numpy(q)
        for f in interop.HMM_FIELDS:
            assert np.array_equal(a[f], b[f]), f


def _contigs():
    """Contigs with the planted domains on both strands, twice on one
    contig (a two-domain cluster), and one with an N."""
    d0, d1 = (jfix.reverse_translate(m) for m in MOTIFS)
    rc = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return [jfix.random_dna(90, 2) + d0 + jfix.random_dna(200, 3) + d1
            + jfix.random_dna(60, 4),
            jfix.random_dna(45, 5) + "".join(rc[c] for c in reversed(d1))
            + jfix.random_dna(75, 6),
            jfix.random_dna(30, 7) + "N" + d0[:90] + jfix.random_dna(40, 8),
            "ACGTA"]


def test_extract_domains_and_bgc_outputs_match_jax(tmp_path):
    profs = [hmm.hmm_from_consensus(f"m{i}", aa.encode_aa(s))
             for i, s in enumerate(MOTIFS)]
    jprofs = [jhmm.hmm_from_consensus(f"m{i}", jaa.encode_aa(s))
              for i, s in enumerate(MOTIFS)]
    contigs = _contigs()
    out = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    for d in out.values():
        d.mkdir()
    hits = bio.extract_domains(contigs, profs, score_threshold=15.0,
                               output_dir=str(out["port"]), device="cpu")
    jhits = jbio.extract_domains(contigs, jprofs, score_threshold=15.0,
                                 output_dir=str(out["jax"]))
    fields = ("name", "desc", "contig", "strand", "nt_start", "nt_end",
              "seq")
    assert [[getattr(h, f) for f in fields] for h in hits] == \
        [[getattr(h, f) for f in fields] for h in jhits]
    np.testing.assert_allclose([h.score for h in hits],
                               [h.score for h in jhits], rtol=SCORE_RTOL)
    assert {h.strand for h in hits} == {1, -1}
    arcs = bio.build_domain_graph(hits, max_gap=500)
    assert arcs == jbio.build_domain_graph(jhits, max_gap=500) and arcs
    chains = bio.bgc_candidates(hits, arcs)
    assert chains == jbio.bgc_candidates(jhits, arcs)
    assert bio.write_bgc_outputs(str(out["port"]), contigs, hits, chains) \
        == jbio.write_bgc_outputs(str(out["jax"]), contigs, jhits, chains)
    for name in BIO_OUTPUTS + ("temp_anti/restricted_edges.fasta",):
        assert (out["port"] / name).read_bytes() == \
            (out["jax"] / name).read_bytes(), name


def test_extract_domains_without_frames_or_hits(tmp_path):
    prof = hmm.hmm_from_consensus("m", aa.encode_aa(MOTIFS[0]))
    assert bio.extract_domains([], [prof], device="cpu") == []
    assert bio.extract_domains(["AC"], [prof], device="cpu") == []
    assert bio.extract_domains([jfix.random_dna(300, 9)], [prof],
                               output_dir=str(tmp_path),
                               device="cpu") == []
    assert (tmp_path / "temp_anti" / "restricted_edges.fasta").read_text() \
        == ""


GAP = simulate.random_genome(600, seed=42)


@pytest.fixture(scope="module")
def hmm_reads(tmp_path_factory):
    """FR pairs (100 bp, insert 300, 40x) of a 4.3 kb genome with two
    reverse-translated domains 600 bases apart, and their profiles as a
    .hmm file."""
    root = tmp_path_factory.mktemp("hmm")
    d0, d1 = (jfix.reverse_translate(m) for m in MOTIFS)
    genome = (simulate.random_genome(1500, seed=41) + d0 + GAP + d1
              + simulate.random_genome(1500, seed=43))
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, len(genome) * 40 // 200, read_len=100, insert_mean=300,
        insert_sd=20, error_rate=0.002, seed=45)
    paths = [str(root / f"bio_{m}.fq") for m in (1, 2)]
    simulate.write_fastq(paths[0], r1, q1)
    simulate.write_fastq(paths[1], r2, q2)
    hmm_path = str(root / "models.hmm")
    hmmfile.write_hmm_file(hmm_path, [
        hmm.hmm_from_consensus(f"dom{i}", aa.encode_aa(m))
        for i, m in enumerate(MOTIFS)])
    return root, paths, hmm_path


@pytest.mark.parametrize("mode", ["--bio", "--corona"])
def test_hmm_command_lines_match_jax(hmm_reads, mode):
    root, (p1, p2), hmm_path = hmm_reads
    argv = ["-1", p1, "-2", p2, mode, "--custom-hmms", hmm_path, "-k",
            "21", "--only-assembler", "--checkpoints", "none"]
    name = mode.strip("-")
    port, jax_out = root / f"port_{name}", root / f"jax_{name}"
    assert cli.main(argv + ["-o", str(port)] + CPU) == 0
    try:
        assert jcli.main(argv + ["-o", str(jax_out)]) == 0
    finally:
        jlogger.configure()
    outputs = OUTPUTS
    if mode == "--bio":  # two-step repeat resolution: the first one's hits
        outputs += ("temp_anti/restricted_edges.fasta",)
    for out_name in outputs:
        assert (port / out_name).read_bytes() == \
            (jax_out / out_name).read_bytes(), out_name
    log = (port / "spades.log").read_text()
    assert "domain graph: 2 hits, 1 arcs, 1 BGC candidates" in log
    if mode == "--bio":
        assert "extracted 2 domain hits from 2 models" in log
    # one cluster: both domains, in order, 600 bases apart
    d0, d1 = (jfix.reverse_translate(m) for m in MOTIFS)
    name, seq = (port / "gene_clusters.fasta").read_text().split()
    assert name.startswith(">cluster_1_dom")
    assert seq in (d0 + GAP + d1, nd.rc(d0 + GAP + d1))
