"""The port's entry points on gloo ranks: ``assemble_single_k``,
``repeat_resolution_multi``, ``correct_reads`` and the command line
take their sharded branches where a process group of world size 2 is
initialised, and give the single-device results. ``assemble_single_k``
runs with early tip clipping (the default: the partitions gathered, the
graph built on every rank) and without it (``no_tips``: the routed
vertex and graph builders).

The inputs are the JAX package's own tests' (``tests/test_parallel_pipeline.py``:
a 6 kb genome with a 200 bp repeat, 900 error-free pairs of 60 bp;
``tests/test_hammer_dist.py``: a 3 kb genome, 500 pairs of 60 bp at 1%
errors with qualities). Contigs are compared in canonical form
(``min(s, revcomp(s))``, sorted); their coverages are float32 means of
integer counts, held within rtol 1e-6 (the sums are exact below 2^24,
so any order gives the same bits). Corrected reads, the paired index and
the chain mappings are held bit for bit. The corrector's float statistics
at world size 2 add two ranks' partial sums: each k-mer's ``total_lq``
is held within n * 2^-23 * sum|x| of the single-device sum (n its
count), ``qual_sum`` (integer phred sums) exactly. At world size 1 every
output equals the single-device path's bits.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from spades_for_blackbird_tpu_torch import cli, interop
from spades_for_blackbird_tpu_torch.hammer import bayes, correct
from spades_for_blackbird_tpu_torch.mapping import chunked, mapper
from spades_for_blackbird_tpu_torch.mapping import index as eidx
from spades_for_blackbird_tpu_torch.ops import dna
from spades_for_blackbird_tpu_torch.paired import pair_info
from spades_for_blackbird_tpu_torch.parallel import hammer_dist, mapping_dist
from spades_for_blackbird_tpu_torch.parallel import mesh as mesh_mod
from spades_for_blackbird_tpu_torch.pipeline import assemble
from spades_for_blackbird_tpu_torch.utils import simulate
from torch_parallel_ranks import run_ranks

K = 21
CPU = "cpu"


def _pairs(seed=11, genome_len=6000, n_pairs=900):
    genome = simulate.random_genome(genome_len, seed=seed,
                                    repeats=[(200, 2)])
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, n_pairs, read_len=60, insert_mean=180.0, insert_sd=12.0,
        error_rate=0.0, seed=seed + 1)
    return genome, (r1, q1, r2, q2)


def _errorful():
    genome = simulate.random_genome(3000, seed=23)
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, 500, read_len=60, insert_mean=150.0, insert_sd=10.0,
        error_rate=0.01, seed=24)
    codes, lengths = dna.encode_reads(r1 + r2)
    quals = np.stack([np.frombuffer(q.encode(), np.uint8) for q in q1 + q2])
    return codes, lengths, quals


def canon(items):
    comp = str.maketrans("ACGT", "TGCA")
    return sorted((min(s, s.translate(comp)[::-1]), c) for s, c in items)


def _inputs(root) -> dict:
    """Everything a rank needs, as NumPy arrays, strings and paths."""
    _, (r1, q1, r2, q2) = _pairs()
    c1, l1 = dna.encode_reads(r1)
    c2, l2 = dna.encode_reads(r2)
    extras_genome, (e1, _, e2, _) = _pairs(seed=23)
    ec1, el1 = dna.encode_reads(e1)
    ec2, el2 = dna.encode_reads(e2)
    rr = assemble.assemble_single_k(np.concatenate([c1, c2]),
                                    np.concatenate([l1, l2]), K,
                                    device=CPU)
    # the command line's input: the 6 kb genome's pairs
    fq = (os.path.join(root, "r_1.fq"), os.path.join(root, "r_2.fq"))
    simulate.write_fastq(fq[0], r1, q1)
    simulate.write_fastq(fq[1], r2, q2)
    return {"reads": (c1, l1, c2, l2),
            "extras_reads": (np.concatenate([ec1, ec2]),
                             np.concatenate([el1, el2])),
            "extras": [extras_genome[1000:1500],
                       extras_genome[2000:2300]],
            "graph": interop.graph_to_numpy(rr.graph),
            "hammer": _errorful(), "fastq": fq,
            "out": os.path.join(root, "cli_out")}


def _assemble(codes, lengths, **kw):
    res = assemble.assemble_single_k(codes, lengths, K, device=CPU, **kw)
    return {"contigs": res.contigs, "graph": interop.graph_to_numpy(
        res.graph), "ec_bound": res.genomic_info.ec_bound}


def _rr(graph: dict, reads):
    g = interop.graph_from_numpy(graph, K, CPU)
    c1, l1, c2, l2 = reads
    contigs, scaffolds = assemble.repeat_resolution_multi(
        g, [(c1, l1, c2, l2, "pe")], with_scaffolds=True, device=CPU)
    return contigs, scaffolds


def _mapping_and_index(graph: dict, reads, fill):
    """Chain mappings of both mates and the paired index, through
    ``chain_map``/``fill`` (sharded or single-device)."""
    g = interop.graph_from_numpy(graph, K, CPU)
    c1, l1, c2, l2 = (torch.as_tensor(x) for x in reads)
    idx = eidx.build_edge_index(g, K + 1, device=CPU)
    ch1 = fill[0](idx, g, c1, l1)
    ch2 = fill[0](idx, g, dna.revcomp_reads(c2, l2), l2)
    pi = fill[1](ch1, ch2, 120)
    n = int(pi.num)
    return ({f: x.numpy() for f, x in zip(ch1._fields, ch1)},
            {f: x.numpy() for f, x in zip(ch2._fields, ch2)},
            {"e1": pi.e1[:n].numpy(), "e2": pi.e2[:n].numpy(),
             "dist": pi.dist[:n].numpy(), "weight": pi.weight[:n].numpy(),
             "num": n})


def _single_map(idx, g, c, ln):
    return mapper.normalize_chain(chunked.map_reads_multi_chunked(
        idx, g.seq_len, c, ln, K + 1, min_votes=1, device=CPU), g.conj)


SINGLE = (_single_map, pair_info.fill_paired_index_multi_chunked)


def pipeline_job(mesh, inp):
    """The entry points on this rank, each through its sharded branch:
    ``auto_mesh`` gives it at world size 2, and a group of one is made
    to give it here too (the way the card runs the sharded path)."""
    if mesh.size == 1:
        mesh_mod.auto_mesh = lambda: mesh
    c1, l1, c2, l2 = inp["reads"]
    codes, lengths = np.concatenate([c1, c2]), np.concatenate([l1, l2])
    out = {"plain": _assemble(codes, lengths),
           "extras": _assemble(*inp["extras_reads"], min_kmer_count=2,
                               extra_sequences=inp["extras"]),
           "auto": _assemble(codes, lengths, min_kmer_count="auto"),
           "no_tips": _assemble(codes, lengths, early_tip_clip=False),
           "rr": _rr(inp["graph"], inp["reads"])}
    sharded = (lambda idx, g, c, ln: mapping_dist.map_reads_multi_sharded(
        mesh, idx, g.seq_len, g.conj, c, ln, K + 1, min_votes=1),
        lambda a, b, s: mapping_dist.fill_paired_index_sharded(mesh, a, b,
                                                               s))
    out["index"] = _mapping_and_index(inp["graph"], inp["reads"], sharded)
    hc, hl, hq = inp["hammer"]
    fixed, stats = correct.correct_reads(hc, hl, quals=hq, device=CPU)
    out["hammer"] = {"codes": fixed.numpy(), "stats": stats}
    c, ln, _ = mesh_mod.shard_reads(mesh, *map(torch.as_tensor, (hc, hl)))
    q, _, _ = mesh_mod.shard_reads(mesh, torch.as_tensor(hq),
                                   torch.as_tensor(hl))
    table, st = hammer_dist._gather_stats_table(
        mesh, *bayes.count_kmers_stats_chunked(c, ln, q, K))
    n = int(table.num)
    out["hammer_table"] = {"kmers": table.kmers[:n].numpy(),
                           "counts": table.counts[:n].numpy(),
                           "total_lq": st.total_lq[:n].numpy(),
                           "qual_sum": st.qual_sum[:n].numpy()}
    if mesh.size > 1:
        # the command line under torchrun-style variables, this group
        f1, f2 = inp["fastq"]
        argv = ["-1", f1, "-2", f2, "-k", "21", "--device", "cpu",
                "-o", inp["out"]]
        out["cli_rc"] = cli.main(argv)
        out["cli_wrote"] = sorted(os.listdir(inp["out"])) \
            if mesh.rank == 0 else None
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return _inputs(str(tmp_path_factory.mktemp("inputs")))


@pytest.fixture(scope="module")
def single(inputs):
    """The single-device results (this process joins no group)."""
    c1, l1, c2, l2 = inputs["reads"]
    codes, lengths = np.concatenate([c1, c2]), np.concatenate([l1, l2])
    hc, hl, hq = inputs["hammer"]
    fixed, stats = correct.correct_reads(hc, hl, quals=hq, device=CPU)
    table, st = bayes.count_kmers_stats_chunked(
        torch.as_tensor(hc), torch.as_tensor(hl), torch.as_tensor(hq), K)
    n = int(table.num)
    return {"plain": _assemble(codes, lengths),
            "extras": _assemble(*inputs["extras_reads"], min_kmer_count=2,
                                extra_sequences=inputs["extras"]),
            "auto": _assemble(codes, lengths, min_kmer_count="auto"),
            "no_tips": _assemble(codes, lengths, early_tip_clip=False),
            "rr": _rr(inputs["graph"], inputs["reads"]),
            "index": _mapping_and_index(inputs["graph"], inputs["reads"],
                                        SINGLE),
            "hammer": {"codes": fixed.numpy(), "stats": stats},
            "hammer_table": {"kmers": table.kmers[:n].numpy(),
                             "counts": table.counts[:n].numpy(),
                             "total_lq": st.total_lq[:n].numpy(),
                             "qual_sum": st.qual_sum[:n].numpy()}}


@pytest.fixture(scope="module")
def world2(tmp_path_factory, inputs):
    env = {"WORLD_SIZE": "2", "RANK": "{rank}", "LOCAL_RANK": "{rank}"}
    return run_ranks(tmp_path_factory.mktemp("pipe2"), 2, pipeline_job,
                     inputs, env=env)


@pytest.fixture(scope="module")
def world1(tmp_path_factory, inputs):
    return run_ranks(tmp_path_factory.mktemp("pipe1"), 1, pipeline_job,
                     inputs)[0]


def _same_contigs(got, want):
    g, w = canon(got), canon(want)
    assert [s for s, _ in g] == [s for s, _ in w]
    np.testing.assert_allclose([c for _, c in g], [c for _, c in w],
                               rtol=1e-6)


@pytest.mark.parametrize("case", ["plain", "extras", "auto", "no_tips"])
def test_assemble_single_k_world2(world2, single, case):
    for r in world2:
        _same_contigs(r[case]["contigs"], single[case]["contigs"])
        assert r[case]["ec_bound"] == single[case]["ec_bound"]
    # every rank holds the same graph; with early tips the whole table's
    # graph, the single-device one
    for f, a in world2[0][case]["graph"].items():
        np.testing.assert_array_equal(world2[1][case]["graph"][f], a)
        if case != "no_tips":
            np.testing.assert_array_equal(single[case]["graph"][f], a)


def test_assemble_single_k_matches_jax_sharded(world2, inputs, monkeypatch):
    """The whole slice against the JAX package's sharded
    ``assemble_single_k`` on a mesh of 2."""
    import jax.numpy as jnp
    from spades_for_blackbird_tpu.parallel import mesh as jmesh
    from spades_for_blackbird_tpu.pipeline import assemble as jassemble
    monkeypatch.setattr(jmesh, "auto_mesh", lambda: jmesh.make_mesh(2))
    c1, l1, c2, l2 = inputs["reads"]
    res = jassemble.assemble_single_k(jnp.asarray(np.concatenate([c1, c2])),
                                      jnp.asarray(np.concatenate([l1, l2])),
                                      K)
    for r in world2:
        _same_contigs(r["plain"]["contigs"], res.contigs)


def test_repeat_resolution_multi_world2(world2, single):
    for r in world2:
        for got, want in zip(r["rr"], single["rr"]):
            _same_contigs(got, want)
        for side in (0, 1, 2):
            for f, a in single["index"][side].items():
                np.testing.assert_array_equal(r["index"][side][f], a,
                                              err_msg=f)


def test_correct_reads_world2(world2, single, inputs):
    codes = inputs["hammer"][0]
    assert single["hammer"]["stats"]["changed_bases"] > 0
    assert (single["hammer"]["codes"] != codes).any()
    for r in world2:
        np.testing.assert_array_equal(r["hammer"]["codes"],
                                      single["hammer"]["codes"])
        assert r["hammer"]["stats"] == single["hammer"]["stats"]
        got, want = r["hammer_table"], single["hammer_table"]
        for f in ("kmers", "counts", "qual_sum"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        bound = want["counts"] * 2.0 ** -23 * np.abs(want["total_lq"])
        assert np.all(np.abs(got["total_lq"] - want["total_lq"]) <= bound)


def test_command_line_world2(world2, inputs, tmp_path):
    """Two ranks through ``cli.main`` under torchrun-style variables:
    rank 0 alone writes, and its contigs are the single-process run's."""
    assert [r["cli_rc"] for r in world2] == [0, 0]
    f1, f2 = inputs["fastq"]
    out = str(tmp_path / "single")
    assert cli.main(["-1", f1, "-2", f2, "-k", "21", "--device", "cpu",
                     "-o", out]) == 0
    assert world2[0]["cli_wrote"] == sorted(os.listdir(out))
    with open(os.path.join(inputs["out"], "spades.log")) as f:
        log = f.read()
    assert log.count("== STAGE k21 done") == 1
    for name in ("contigs.fasta", "scaffolds.fasta", "before_rr.fasta"):
        # the strand a contig is written on follows the edge numbering,
        # which the partition layout sets
        assert _fasta_canon(os.path.join(inputs["out"], name)) == \
            _fasta_canon(os.path.join(out, name)), name


def _fasta_canon(path):
    """Canonical (sequence, header without the node number) records."""
    with open(path) as f:
        recs = f.read().split(">")[1:]
    return canon(("".join(r.splitlines()[1:]),
                  r.splitlines()[0].split("_", 2)[2]) for r in recs)


def test_world1_equals_single_device(world1, single):
    """The sharded branches on a group of one give the single-device
    path's bits: contigs with their coverage, graphs, the repeat
    resolution, the mappings and paired index, the corrected reads,
    the corrector's table and float statistics."""
    for case in ("plain", "extras", "auto", "no_tips"):
        assert world1[case]["contigs"] == single[case]["contigs"]
        for f, a in single[case]["graph"].items():
            np.testing.assert_array_equal(world1[case]["graph"][f], a)
    assert world1["rr"] == single["rr"]
    for side in (0, 1, 2):
        for f, a in single["index"][side].items():
            np.testing.assert_array_equal(world1["index"][side][f], a)
    np.testing.assert_array_equal(world1["hammer"]["codes"],
                                  single["hammer"]["codes"])
    assert world1["hammer"]["stats"] == single["hammer"]["stats"]
    for f, a in single["hammer_table"].items():
        np.testing.assert_array_equal(world1["hammer_table"][f], a)
