"""The PyTorch port's ``tools`` entry point vs the JAX package's, tool by
tool, on the inputs of ``tests/test_tools.py``, ``tests/test_vis_tools.py``
and ``tests/test_long_read.py``: the same arguments (``--device cpu``
added for the port), byte-identical output files, standard output and
standard error (paths to each package's own output directory read as
one; the time-stamped lines of the packages' loggers, which differ,
are left out). Here: the graph and k-mer tools (gbuilder, kmercount,
kmer-estimating, read-filter, gsimplifier, unitig-coverage,
edge-positions, corrector, bin-converter, gmapper, truseq-analysis). The
other tools are held to the JAX package by tests/test_torch_vis_io.py
and tests/test_torch_hll_positions.py.
"""

import gzip
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import naive_debruijn as nd  # noqa: E402
from spades_for_blackbird_tpu import cli as jcli  # noqa: E402
from spades_for_blackbird_tpu import tools as jtools  # noqa: E402
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import tools  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

K = 15


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    jlogger.configure()
    yield
    jlogger.configure()


def random_dna(n, seed):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), size=n))


def tile(s, L=50, step=5):
    r = [s[i:i + L] for i in range(0, len(s) - L + 1, step)]
    r.append(s[len(s) - L:])
    return r


def write_reads(path, reads):
    path.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    return str(path)


def noisy(seq, rate, seed):
    """tests/test_long_read.py::noisy: substitutions, insertions and
    deletions at ``rate``."""
    rng = np.random.default_rng(seed)
    out = []
    for c in seq:
        r = rng.random()
        if r < rate / 3:
            out.append(rng.choice(list("ACGT")))
        elif r < 2 * rate / 3:
            out.append(c + rng.choice(list("ACGT")))
        elif r < rate:
            continue
        else:
            out.append(c)
    return "".join(out)


_LOG_LINE = re.compile(r"^\d\d:\d\d:\d\d  [A-Z]+ \[.*\n", re.M)


def _files(d):
    """Every file under ``d`` (gzip members decompressed: their header
    holds a time), by path relative to ``d``."""
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                data = f.read()
            if n.endswith(".gz"):
                data = gzip.decompress(data)
            out[os.path.relpath(p, d)] = data
    return out


def run_both(tmp_path, capsys, argv_of, skip=()):
    """Run ``argv_of(out_dir)`` through both packages' ``tools.main``,
    each into an output directory of its own; return the port's
    (rc, stdout, stderr, files) after asserting it equals the JAX
    package's. Files or directories named in ``skip`` (a run's own log,
    its saves) are left out of the comparison."""
    capsys.readouterr()  # what ran before, the inputs' own tools
    got = []
    for name, main, extra in (("jax", jtools.main, []),
                              ("port", tools.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        rc = main(argv_of(str(d)) + extra)
        jlogger.configure()
        cap = capsys.readouterr()
        files = {p: v for p, v in _files(d).items()
                 if not set(p.split(os.sep)) & set(skip)}
        got.append((rc, _LOG_LINE.sub("", cap.out).replace(str(d), "<out>"),
                    _LOG_LINE.sub("", cap.err).replace(str(d), "<out>"),
                    files))
    assert got[1][0] == got[0][0]
    assert got[1][1] == got[0][1]
    assert got[1][2] == got[0][2]
    assert sorted(got[1][3]) == sorted(got[0][3])
    for path in got[0][3]:
        assert got[1][3][path] == got[0][3][path], path
    return got[1]


@pytest.fixture
def reads_file(tmp_path):
    genome = random_dna(300, 1)
    reads = [genome[i:i + 50] for i in range(0, 251, 5)]
    d = tmp_path / "in"
    d.mkdir()
    return write_reads(d / "reads.fa", reads), genome


def build_gfa(tmp_path, reads, name="g.gfa", k=K):
    """A GFA written by the JAX package's gbuilder (the input both
    packages' graph tools then read)."""
    d = tmp_path / "in"
    d.mkdir(exist_ok=True)
    rp = write_reads(d / f"reads_for_{name}.fa", reads)
    gfa_p = str(d / name)
    assert jtools.main(["gbuilder", rp, "-k", str(k), "--gfa", gfa_p]) == 0
    return gfa_p


def test_gbuilder(reads_file, tmp_path, capsys):
    path, genome = reads_file
    rc, out, _, files = run_both(tmp_path, capsys, lambda d: [
        "gbuilder", path, "-k", str(K), "--gfa", f"{d}/g.gfa",
        "--fastg", f"{d}/g.fastg", "--unitigs", f"{d}/u.fasta"])
    assert rc == 0 and out.startswith("graph: ")
    body = b"".join(ln for ln in files["u.fasta"].splitlines()
                    if not ln.startswith(b">")).decode()
    assert body in (genome, nd.rc(genome))


def test_gbuilder_on_simulated_pairs(tmp_path, capsys):
    """A 20 kb simulation with read errors and a repeat: many edges."""
    genome = simulate.random_genome(20_000, seed=91, repeats=[(400, 2)])
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, 2500, read_len=100, error_rate=0.003, seed=92)
    d = tmp_path / "in"
    d.mkdir()
    simulate.write_fastq(str(d / "r1.fq"), r1, q1)
    simulate.write_fastq(str(d / "r2.fq"), r2, q2)
    rc, out, _, _ = run_both(tmp_path, capsys, lambda o: [
        "gbuilder", str(d / "r1.fq"), str(d / "r2.fq"), "-k", "33",
        "--min-count", "2", "--gfa", f"{o}/g.gfa", "--unitigs",
        f"{o}/u.fasta"])
    assert rc == 0 and "'edges'" in out


@pytest.mark.parametrize("min_count", [1, 2])
def test_kmercount(reads_file, tmp_path, capsys, min_count):
    path, genome = reads_file
    _, _, err, files = run_both(tmp_path, capsys, lambda d: [
        "kmercount", path, "-k", str(K), "-o", f"{d}/counts.tsv",
        "--min-count", str(min_count)])
    lines = files["counts.tsv"].decode().splitlines()
    assert err == f"{len(lines)} distinct canonical {K}-mers\n"
    if min_count == 1:
        reads = [genome[i:i + 50] for i in range(0, 251, 5)]
        assert len(lines) == len(nd.canonical_counts(reads, K))


def test_kmercount_to_stdout(reads_file, tmp_path, capsys):
    path, _ = reads_file
    _, out, _, _ = run_both(tmp_path, capsys,
                            lambda d: ["kmercount", path, "-k", "21"])
    assert out.count("\n") > 100


def test_kmer_estimating(reads_file, tmp_path, capsys):
    path, _ = reads_file
    rc, out, _, _ = run_both(tmp_path, capsys,
                             lambda d: ["kmer-estimating", path, "-k", "15"])
    assert rc == 0 and abs(float(out) - 286) / 286 < 0.1


def test_read_filter(tmp_path, capsys):
    genome = random_dna(300, 2)
    good = [genome[i:i + 50] for i in range(0, 250, 5)]
    junk = [random_dna(50, 100 + i) for i in range(3)]
    d = tmp_path / "in"
    d.mkdir()
    p = write_reads(d / "reads.fa", good + junk + ["ACGTN" * 10])
    _, _, err, files = run_both(tmp_path, capsys, lambda o: [
        "read-filter", p, "-k", "15", "--min-coverage", "2",
        "-o", f"{o}/filtered.fa"])
    kept = files["filtered.fa"].decode()
    assert all(j not in kept for j in junk) and good[10] in kept
    assert err.startswith("kept ")


def test_gsimplifier(tmp_path, capsys):
    genome = random_dna(600, 21)
    reads = tile(genome) * 3 + [genome[200:230] + random_dna(30, 22)]
    gfa_p = build_gfa(tmp_path, reads)
    rc, _, err, _ = run_both(tmp_path, capsys, lambda d: [
        "gsimplifier", gfa_p, f"{d}/out.gfa", "--read-length", "50"])
    assert rc == 0 and err.startswith("simplified: ")


def test_unitig_coverage(tmp_path, capsys):
    genome = random_dna(300, 3)
    reads = tile(genome) * 4
    gfa_p = build_gfa(tmp_path, reads)
    rp = write_reads(tmp_path / "in" / "reads.fa", reads)
    _, _, _, files = run_both(tmp_path, capsys, lambda d: [
        "unitig-coverage", gfa_p, rp, "-o", f"{d}/cov.tsv"])
    assert len(files["cov.tsv"].splitlines()) == 1


def test_unitig_coverage_many_edges(tmp_path, capsys):
    genome = simulate.random_genome(8000, seed=23, repeats=[(300, 3)])
    reads = tile(genome, L=60, step=3)
    gfa_p = build_gfa(tmp_path, reads, k=21)
    rp = write_reads(tmp_path / "in" / "reads.fa", reads[::2])
    _, out, _, _ = run_both(tmp_path, capsys,
                            lambda d: ["unitig-coverage", gfa_p, rp])
    assert out.count("\n") > 3


def test_edge_positions(tmp_path, capsys):
    genome = simulate.random_genome(6000, seed=24, repeats=[(300, 2)])
    gfa_p = build_gfa(tmp_path, tile(genome, L=60, step=3), k=21)
    ref = tmp_path / "in" / "ref.fa"
    ref.write_text(f">chr\n{genome}\n>part\n{genome[1000:2500]}\n")
    _, _, _, files = run_both(tmp_path, capsys, lambda d: [
        "edge-positions", gfa_p, str(ref), "-o", f"{d}/pos.tsv"])
    assert files["pos.tsv"].count(b"\tchr\t") >= 3


def test_corrector(tmp_path, capsys):
    genome = random_dna(400, 10)
    rp = write_reads(tmp_path / "reads.fa", tile(genome, L=60, step=4))
    bad = list(genome)
    bad[100] = "A" if bad[100] != "A" else "C"
    bad[250] = "G" if bad[250] != "G" else "T"
    cp = tmp_path / "contigs.fa"
    cp.write_text(">c1\n" + "".join(bad) + "\n>c2\n" + genome[:200] + "\n")
    _, _, err, files = run_both(tmp_path, capsys, lambda d: [
        "corrector", str(cp), rp, "-o", f"{d}/fixed.fa"])
    assert genome.encode() in files["fixed.fa"]
    assert err.startswith("corrected ") and err.endswith(" in 2 contigs\n")


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_bin_converter(tmp_path, capsys, saved_by):
    """Both packages' tools read the saves either command line wrote."""
    from spades_for_blackbird_tpu_torch import cli
    genome = random_dna(300, 9)
    rp = write_reads(tmp_path / "reads.fa", tile(genome))
    out = tmp_path / "run"
    argv = ["-s", rp, "-o", str(out), "--only-assembler", "-k", "15",
            "--checkpoints", "all", "--stop-after", "read_conversion"]
    if saved_by == "jax":
        assert jcli.main(argv) == 0
    else:
        assert cli.main(argv + ["--device", "cpu"]) == 0
    jlogger.configure()
    capsys.readouterr()
    save = str(out / "saves" / "read_conversion")
    _, _, _, files = run_both(tmp_path, capsys, lambda d: [
        "bin-converter", save, "-o", f"{d}/back.fastq.gz"])
    assert tile(genome)[0].encode() in files["back.fastq.gz"]


@pytest.mark.parametrize("formats", [None, "tsv,gpa,fasta"])
def test_gmapper(tmp_path, capsys, formats):
    genome = random_dna(400, 5)
    gfa_p = build_gfa(tmp_path, tile(genome))
    lr = tmp_path / "in" / "lr.fa"
    lr.write_text(f">lr0\n{noisy(genome[40:360], 0.08, 6)}\n"
                  f">lr1\n{nd.rc(noisy(genome[10:300], 0.05, 7))}\n"
                  f">lr2\n{random_dna(200, 8)}\n")
    if formats is None:
        def argv(d):
            return ["gmapper", gfa_p, str(lr), "-o", f"{d}/al.tsv"]
    else:
        def argv(d):
            return ["gmapper", gfa_p, str(lr), "--output-dir",
                    f"{d}/sp", "--output-format", formats]
    _, _, err, files = run_both(tmp_path, capsys, argv)
    assert err == "aligned 2/3 reads\n"
    assert len(files) == (1 if formats is None else 3)


def test_truseq_analysis(tmp_path, capsys):
    rng = np.random.default_rng(17)
    genome = "".join(rng.choice(list("ACGT"), size=3000))
    reads = [genome[i:i + 120] for i in range(0, 3000 - 120, 7)]
    rp = write_reads(tmp_path / "reads.fa", reads)
    insertion = "".join(rng.choice(list("ACGT"), size=600))
    variant = genome[:1500] + insertion + genome[1500:]
    parts = tmp_path / "parts.fa"
    parts.write_text(f">clean\n{genome}\n>variant\n{variant}\n")
    _, _, _, files = run_both(tmp_path, capsys, lambda d: [
        "truseq-analysis", "--dataset", rp, "--genome", str(parts),
        "-k", "55", "-o", f"{d}/report"])
    assert b"Deletion (" in files["report"]


def test_unknown_tool_and_help(capsys):
    assert tools.main(["bogus"]) == jtools.main(["bogus"]) == 2
    assert tools.main([]) == 2
    assert set(tools.TOOLS) == set(jtools.TOOLS)
    capsys.readouterr()


def test_without_a_card_a_tool_exits_1(reads_file, capsys):
    if torch.cuda.is_available():
        pytest.skip("shows the refusal on a machine without a card")
    path, _ = reads_file
    assert tools.main(["kmer-estimating", path]) == 1
    assert "CUDA card" in capsys.readouterr().err
