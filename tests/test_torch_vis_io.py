"""The PyTorch port's inspector, graph exports and legacy loader vs the
JAX package's: the ``vis`` REPL, ``scf-correction`` (and
``path_extend/scf_correction.py``), ``cds-subgraphs``, ``mag-improve``,
``truspades``, ``io/graph_json.py``, ``io/webvis.py`` and
``io/legacy_text.py``, on the inputs of ``tests/test_vis_tools.py``,
``tests/test_truspades_webvis.py`` and ``tests/test_rna_rcc_json.py``:
byte-identical outputs (``tests/test_torch_tools.py::run_both``); the
legacy loader's graph field by field, coverages exact.
"""

import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import naive_debruijn as nd  # noqa: E402
from spades_for_blackbird_tpu.graph import construct as jconstruct  # noqa: E402
from spades_for_blackbird_tpu.graph.from_gfa import (  # noqa: E402
    graph_from_gfa as jgraph_from_gfa)
from spades_for_blackbird_tpu.io import graph_json as jgraph_json  # noqa: E402
from spades_for_blackbird_tpu.io import legacy_text as jlegacy  # noqa: E402
from spades_for_blackbird_tpu.io import webvis as jwebvis  # noqa: E402
from spades_for_blackbird_tpu.path_extend import (  # noqa: E402
    scf_correction as jscf)
from spades_for_blackbird_tpu_torch import interop  # noqa: E402
from spades_for_blackbird_tpu_torch.graph import construct  # noqa: E402
from spades_for_blackbird_tpu_torch.graph.from_gfa import (  # noqa: E402
    graph_from_gfa)
from spades_for_blackbird_tpu_torch.io import (  # noqa: E402
    graph_json, legacy_text, webvis)
from spades_for_blackbird_tpu_torch.ops import aa, dna, hmm  # noqa: E402
from spades_for_blackbird_tpu_torch.path_extend import (  # noqa: E402
    scf_correction)
from test_torch_tools import (  # noqa: E402
    _single_device, build_gfa, random_dna, run_both, tile, write_reads)

K = 15
assert _single_device  # the autouse fixture, imported to apply here


def test_vis_repl(tmp_path, capsys, monkeypatch):
    genome = random_dna(300, 1)
    gfa_p = build_gfa(tmp_path, tile(genome) + [genome[100:130]
                                                + random_dna(30, 2)])

    def argv(d):
        monkeypatch.setattr("sys.stdin", io.StringIO(
            f"stats\nedges 5\nedge 0\nseq 0 0 20\nfind {genome[50:70]}\n"
            f"find ACGTACGTACGTACGTAAAA\nneigh 0 1\ndraw 0 1 {d}/n.dot\n"
            f"html {d}/g.html\nhelp\nbogus\nedge\nquit\n"))
        return ["vis", gfa_p]
    rc, out, _, files = run_both(tmp_path, capsys, argv)
    assert rc == 0 and "loaded" in out and "unknown command" in out
    assert files["n.dot"].startswith(b"digraph")


def test_vis_load_command(tmp_path, capsys, monkeypatch):
    gfa_p = build_gfa(tmp_path, tile(random_dna(300, 3)))

    def argv(d):
        monkeypatch.setattr("sys.stdin", io.StringIO(
            f"stats\nload {gfa_p}\nstats\nedges\n"))
        return ["vis"]
    _, out, _, _ = run_both(tmp_path, capsys, argv)
    assert out.startswith("no graph loaded")


@pytest.mark.parametrize("gap", [40, 0])
def test_scf_correction(tmp_path, capsys, gap):
    genome = random_dna(400, 2)
    gfa_p = build_gfa(tmp_path, tile(genome))
    scf = tmp_path / "in" / "scaffolds.fasta"
    scf.write_text(f">scf1\n{genome[:150] + 'N' * gap + genome[150 + gap:]}"
                   f"\n>scf2\n{random_dna(120, 3)}\n>scf3\nNNNN\n")
    _, _, err, files = run_both(tmp_path, capsys, lambda d: [
        "scf-correction", gfa_p, str(scf), "-o", f"{d}/corrected.fasta"])
    assert err.startswith("corrected ")
    assert genome.encode() in files["corrected.fasta"] or \
        nd.rc(genome).encode() in files["corrected.fasta"]


def test_correct_scaffolds_matches_jax(tmp_path):
    """The module on a branching graph: one scaffold through a repeat's
    junction, one across an N run between two pieces."""
    a, r, b, c = (random_dna(n, s) for n, s in ((300, 11), (60, 12),
                                                (300, 13), (300, 14)))
    reads = tile(a + r + b) * 3 + tile(c + r + b) * 3
    gfa_p = build_gfa(tmp_path, reads)
    g = graph_from_gfa(gfa_p, device="cpu")
    jg = jgraph_from_gfa(gfa_p)
    scaffolds = [("s1", a + r + b), ("s2", a[:200] + "N" * 100 + a[250:]
                                     + r + b[:100]),
                 ("s3", c[:250] + "N" * 30 + c[280:] + r)]
    assert scf_correction.correct_scaffolds(g, scaffolds, device="cpu") \
        == jscf.correct_scaffolds(jg, scaffolds)


def _domain_genome():
    motif = "MAGICHEMISTRYWKDNVFQ"
    codon_of = {}
    for codon, a_ in aa._CODON_TABLE_STR.items():
        codon_of.setdefault(a_, codon)
    dna_m = "".join(codon_of[c] for c in motif)
    return motif, dna_m, random_dna(120, 4) + dna_m + random_dna(120, 5)


@pytest.mark.parametrize("radius", [0, 2])
def test_cds_subgraphs(tmp_path, capsys, radius):
    from spades_for_blackbird_tpu_torch.io import hmmfile
    motif, dna_m, genome = _domain_genome()
    gfa_p = build_gfa(tmp_path, tile(genome) + tile(genome[100:250]
                                                     + random_dna(80, 6)))
    prof = hmm.hmm_from_consensus("mot", aa.encode_aa(motif))
    hmm_p = str(tmp_path / "in" / "m.hmm")
    hmmfile.write_hmm_file(hmm_p, [prof])
    _, _, err, files = run_both(tmp_path, capsys, lambda d: [
        "cds-subgraphs", gfa_p, "--hmms", hmm_p, "-o", f"{d}/cds",
        "--threshold", "15", "--radius", str(radius)])
    cds = files["cds.cds.fasta"].decode()
    assert dna_m in cds or nd.rc(dna_m) in cds
    assert " CDS hits, subgraph of " in err


def test_mag_improve(tmp_path, capsys):
    stem, b1, b2 = random_dna(200, 6), random_dna(120, 7), random_dna(120, 8)
    reads = tile(stem + b1) * 3 + tile(stem + b2) * 3
    gfa_p = build_gfa(tmp_path, reads)
    mag = tmp_path / "in" / "mag.fa"
    mag.write_text(f">m1\n{stem + b1}\n")
    for extra in ([], ["--radius", "2", "--max-added-length", "50"]):
        out = tmp_path / "run"
        out.mkdir()
        _, _, _, files = run_both(out, capsys, lambda d: [
            "mag-improve", gfa_p, str(mag), "-o", f"{d}/improved.fa"]
            + extra)
        assert b"added_edge_" in files["improved.fa"]
        os.rename(out, tmp_path / f"run{len(extra)}")


def test_truspades(tmp_path, capsys):
    g1, g2 = random_dna(300, 1), random_dna(300, 2)
    bdir = tmp_path / "in" / "barcodes"
    bdir.mkdir(parents=True)
    write_reads(bdir / "BC01.fasta", tile(g1))
    write_reads(bdir / "BC02_1.fasta", tile(g2)[::2])
    write_reads(bdir / "BC02_2.fasta",
                [nd.rc(r) for r in tile(g2)[1::2][:len(tile(g2)[::2])]])
    (bdir / "notes.txt").write_text("not reads\n")
    rc, _, err, files = run_both(
        tmp_path, capsys, lambda d: ["truspades", "--input-dir", str(bdir),
                                     "-o", d, "-k", str(K)],
        skip=("spades.log", "params.json", "saves"))
    assert rc == 0 and b">BC01_" in files["TSLR.fasta"]
    assert "barcodes" in err


def test_graph_json_and_webvis_match_jax(tmp_path):
    genome = random_dna(250, 3)
    reads = tile(genome) + tile(genome[50:150] + random_dna(60, 9))
    codes, lengths = dna.encode_reads(reads)
    g = construct.graph_from_reads(codes, lengths, K, device="cpu")
    jg = jconstruct.graph_from_reads(codes, lengths, K)
    assert graph_json.graph_to_json(g) == jgraph_json.graph_to_json(jg)
    for mod, graph, name in ((graph_json, g, "p"), (jgraph_json, jg, "j")):
        mod.write_graph_json(str(tmp_path / f"{name}.json"), graph)
    for mod, graph, name in ((webvis, g, "p"), (jwebvis, jg, "j")):
        mod.write_webvis_html(str(tmp_path / f"{name}.html"), graph)
    for ext in ("json", "html"):
        assert (tmp_path / f"p.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
    doc = json.loads((tmp_path / "p.json").read_text())
    assert doc["k"] == K and len(doc["links"]) > 1


def _legacy_prefix(tmp_path, fasta_sqn: bool, with_cov: bool):
    """A legacy text save of a k = 55 fragment in the format
    ``_read_sequences`` / ``_read_edge_floats`` parse: three edges on a
    fork and their conjugates (the ``.sqn`` as FASTA or as the old
    ``E`` form)."""
    k = 55
    rng = np.random.default_rng(7)
    stem = "".join(rng.choice(list("ACGT"), size=200))
    br1 = stem[-k:] + "".join(rng.choice(list("ACGT"), size=150))
    br2 = stem[-k:] + "".join(rng.choice(list("ACGT"), size=90))
    seqs = {1: stem, 2: nd.rc(stem), 3: br1, 4: nd.rc(br1), 5: br2,
            6: nd.rc(br2)}
    # vertices: 10 ~ 11 (start of stem), 12 ~ 13 (fork), 14 ~ 15, 16 ~ 17
    edges = [(1, 10, 12, 2), (2, 13, 11, 1), (3, 12, 14, 4),
             (4, 15, 13, 3), (5, 12, 16, 6), (6, 17, 13, 5)]
    p = tmp_path / "fragment"
    lines = [f"{8} {len(edges)}"]
    lines += [f"Vertex {a} ~ {b} ." for a, b in ((10, 11), (11, 10),
                                                  (12, 13), (13, 12),
                                                  (14, 15), (15, 14),
                                                  (16, 17), (17, 16))]
    lines += [f"Edge {e} : {u} -> {w}, l = {len(seqs[e]) - k} ~ {c} ."
              for e, u, w, c in edges]
    (tmp_path / "fragment.grp").write_text("\n".join(lines) + "\n")
    if fasta_sqn:
        text = "".join(f">{e}\n{s[:70]}\n{s[70:]}\n" for e, s in seqs.items())
    else:
        text = f"{len(seqs)}\n" + "".join(f"{e} {s} .\n"
                                          for e, s in seqs.items())
    (tmp_path / "fragment.sqn").write_text(text)
    if with_cov:
        (tmp_path / "fragment.cvr").write_text(
            f"{len(seqs)}\n" + "".join(f"{e} {10.5 + e} .\n" for e in seqs))
        (tmp_path / "fragment.flcvr").write_text(
            f"{len(seqs)}\n" + "".join(f"{e} {400 + 3 * e}\n" for e in seqs))
    return str(p)


@pytest.mark.parametrize("fasta_sqn,with_cov", [(True, True),
                                                (False, False)])
def test_legacy_loader_matches_jax(tmp_path, fasta_sqn, with_cov):
    prefix = _legacy_prefix(tmp_path, fasta_sqn, with_cov)
    g, vs = legacy_text.load_legacy_graph(prefix, device="cpu")
    jg, jvs = jlegacy.load_legacy_graph(prefix)
    assert vs == jvs and g.k == jg.k == 55
    a = interop.graph_to_numpy(g)
    b = interop.fields_of(jg, interop.GRAPH_FIELDS)
    for name in ("seq_flat", "seq_start", "seq_len", "start_v", "end_v",
                 "conj", "alive", "num_edges", "cov", "flank"):
        if b[name] is None:
            assert a[name] is None, name
        else:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert int(np.asarray(b["alive"]).sum()) == 6
