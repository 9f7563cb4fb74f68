"""The port's ``parallel/*`` modules on gloo ranks, against the JAX
package's ``parallel/*`` on a mesh of the same size and against the
port's single-device functions.

Each world size's ranks are spawned once for the file (a module
fixture): they run every module on the JAX tests' inputs (64-74 random
reads of 80 bp, ``tests/test_parallel.py``; reads of a 600 bp genome,
``tests/test_parallel_construction.py``; a genome with a repeat and the
chain cases of ``tests/test_condense_dist.py``) and return NumPy
results. JAX is imported inside the test functions only, so the spawned
ranks never import it. Tables are held bit for bit: a rank's rows below
``num`` equal the JAX shard's rows below its ``nums`` entry (both
partitions depend only on the hash, not on how the reads split).
Graphs are held in canonical form (sorted canonical sequences with
their coverage rounded to 4 decimals); at world size 1 the graph's
arrays equal the single-device build's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spades_for_blackbird_tpu_torch import interop
from spades_for_blackbird_tpu_torch.graph import condense, pointer_jump
from spades_for_blackbird_tpu_torch.io import fasta
from spades_for_blackbird_tpu_torch.kmers import counter, extension
from spades_for_blackbird_tpu_torch.kmers.hll import kmer_hash
from spades_for_blackbird_tpu_torch.ops import dna
from spades_for_blackbird_tpu_torch.parallel import (
    condense_dist, construction, kmer_exchange, mesh as mesh_mod)
from torch_parallel_ranks import run_ranks

K = 21


def _count_reads():
    rng = np.random.default_rng(0)
    seqs = ["".join(rng.choice(list("ACGT"), size=80)) for _ in range(64)]
    return dna.encode_reads(seqs + seqs[:10])


def _vertex_reads():
    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), size=600))
    return dna.encode_reads([genome[i:i + 70] for i in range(0, 530, 3)])


def _graph_reads():
    rng = np.random.default_rng(11)
    rep = "".join(rng.choice(list("ACGT"), size=60))
    core = "".join(rng.choice(list("ACGT"), size=500))
    genome = core[:150] + rep + core[150:350] + rep + core[350:]
    return dna.encode_reads([genome[i:i + 70]
                             for i in range(0, len(genome) - 70, 2)])


def _chain_case(N, seed, with_cycle=False):
    """tests/test_condense_dist.py's successor arrays."""
    rng = np.random.default_rng(seed)
    succ = np.full(N, N, np.int64)
    conj = np.arange(N, dtype=np.int64) ^ 1
    valid = np.ones(N, bool)
    perm = rng.permutation(np.arange(8, N, 2))
    for a, b in zip(perm[:-1:2], perm[1::2]):
        succ[a] = b
        succ[b ^ 1] = a ^ 1
    if with_cycle:
        a, b, c = 0, 2, 4
        succ[a], succ[b], succ[c] = b, c, a
        succ[b ^ 1], succ[c ^ 1], succ[a ^ 1] = a ^ 1, b ^ 1, c ^ 1
    return succ, conj, valid


CHAIN_CASES = ((0, False), (1, True))


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _table_rows(t) -> dict:
    n = int(t.num)
    return {"kmers": t.kmers[:n].numpy().astype(np.uint32),
            "counts": t.counts[:n].numpy().astype(np.int32),
            "num": n, "capacity": t.capacity}


def _vt_rows(vt) -> dict:
    n = int(vt.num)
    return {"kmers": vt.kmers[:n].numpy().astype(np.uint32),
            "out_mask": vt.out_mask[:n].numpy(),
            "in_mask": vt.in_mask[:n].numpy(), "num": n}


def canon(items):
    comp = str.maketrans("ACGT", "TGCA")
    return sorted((min(s, s.translate(comp)[::-1]), round(c, 4))
                  for s, c in items)


def modules_job(mesh, _):
    """Every module of ``parallel/`` on this rank's share of the inputs."""
    out = {}
    c, ln, _ = mesh_mod.shard_reads(mesh, *map(_t, _count_reads()))
    t = kmer_exchange.make_sharded_counter(mesh, K)(c, ln)
    out["count"] = _table_rows(t)
    merged = kmer_exchange.make_sharded_table_merge(mesh)(t, t)
    out["merge"] = _table_rows(merged)
    out["filter"] = _table_rows(
        kmer_exchange.make_sharded_min_count_filter(mesh)(merged, 3))

    c, ln, _ = mesh_mod.shard_reads(mesh, *map(_t, _vertex_reads()))
    kp1 = kmer_exchange.make_sharded_counter(mesh, K + 1)(c, ln)
    vt = construction.make_sharded_vertex_builder(mesh, K)(kp1)
    out["kp1"] = _table_rows(kp1)
    out["vertex"] = _vt_rows(vt)
    out["gathered_vertex"] = _vt_rows(
        construction.gather_vertex_table(mesh, vt))

    c, ln, _ = mesh_mod.shard_reads(mesh, *map(_t, _graph_reads()))
    kp1 = kmer_exchange.make_sharded_counter(mesh, K + 1)(c, ln)
    vt = construction.make_sharded_vertex_builder(mesh, K)(kp1)
    g = condense_dist.make_sharded_graph_builder(mesh, K)(kp1, vt)
    out["graph"] = interop.graph_to_numpy(g)
    out["contigs"] = canon(fasta.graph_contigs(g, min_length=0))

    out["chains"] = []
    for seed, cyc in CHAIN_CASES:
        succ, conj, valid = _chain_case(1024, seed, cyc)
        per = 1024 // mesh.size
        lo, hi = mesh.rank * per, (mesh.rank + 1) * per
        ch = condense_dist.contract_chains_sharded(
            mesh, _t(succ[lo:hi]), _t(conj[lo:hi]), _t(valid[lo:hi]))
        out["chains"].append({f: getattr(ch, f).numpy()
                              for f in ch._fields})

    # one read: the other rank holds only padding
    codes, lengths = _count_reads()
    c, ln, _ = mesh_mod.shard_reads(mesh, _t(codes[:1]), _t(lengths[:1]))
    kp1 = kmer_exchange.make_sharded_counter(mesh, K + 1)(c, ln)
    vt = construction.make_sharded_vertex_builder(mesh, K)(kp1)
    g = condense_dist.make_sharded_graph_builder(mesh, K)(kp1, vt)
    out["one_read"] = {"num": int(kp1.num),
                       "contigs": canon(fasta.graph_contigs(g, 0))}
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("world2"), 2, modules_job)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("world1"), 1, modules_job)[0]


def _single_graph(codes, lengths):
    kp1 = counter.count_kmers(_t(codes), _t(lengths), K + 1)
    return condense.build_graph(kp1, extension.build_vertex_table(kp1, K),
                                K)


def _jax_shards(kmers, nums, fields=None):
    """The JAX shards' real rows: [(rows of each field)] a shard."""
    nums = np.asarray(nums)
    per = np.asarray(kmers).shape[0] // len(nums)
    out = []
    for d, n in enumerate(nums):
        sl = slice(d * per, d * per + int(n))
        out.append([np.asarray(kmers)[sl]]
                   + [np.asarray(f)[sl] for f in fields or ()])
    return out


def test_kmer_hash_owners_match_jax():
    from spades_for_blackbird_tpu.parallel import kmer_exchange as jx
    rng = np.random.default_rng(3)
    for W in (1, 2, 4, 8):
        words = rng.integers(0, 1 << 32, size=(5000, W), dtype=np.uint64
                             ).astype(np.uint32)
        want = np.asarray(jx.kmer_hash(words))
        got = kmer_hash(torch.from_numpy(words.astype(np.int64))).numpy()
        np.testing.assert_array_equal(got.astype(np.uint32), want)
        for D in (2, 3, 8):
            np.testing.assert_array_equal(got % D, want % D)


def test_sharded_counter_merge_filter_match_jax(world2):
    import jax.numpy as jnp
    from spades_for_blackbird_tpu.parallel import kmer_exchange as jx
    from spades_for_blackbird_tpu.parallel import mesh as jmesh
    m = jmesh.make_mesh(2)
    codes, lengths = _count_reads()
    sc, sl = jmesh.shard_reads(m, codes, lengths)
    kk, cc, nn, dropped = jx.make_sharded_counter(m, K)(sc, sl)
    assert int(np.asarray(dropped).sum()) == 0
    mk, mc, mn = jx.make_sharded_table_merge(m)(kk, cc, nn, kk, cc, nn)
    fk, fc, fn = jx.make_sharded_min_count_filter(m)(
        mk, mc, mn, jnp.asarray([3], jnp.int32))
    for name, (k_, c_, n_) in (("count", (kk, cc, nn)),
                               ("merge", (mk, mc, mn)),
                               ("filter", (fk, fc, fn))):
        for rank, (rows, counts) in enumerate(_jax_shards(k_, n_, [c_])):
            got = world2[rank][name]
            np.testing.assert_array_equal(got["kmers"], rows, err_msg=name)
            np.testing.assert_array_equal(got["counts"], counts,
                                          err_msg=name)
    # the partitions together are the single-device table
    single = counter.count_kmers(_t(codes), _t(lengths), K)
    n = int(single.num)
    rows = np.concatenate([r["count"]["kmers"] for r in world2])
    order = np.lexsort(rows.T[::-1])
    np.testing.assert_array_equal(rows[order],
                                  single.kmers[:n].numpy().astype(np.uint32))


def test_sharded_vertex_builder_matches_jax(world2):
    from spades_for_blackbird_tpu.parallel import construction as jc
    from spades_for_blackbird_tpu.parallel import kmer_exchange as jx
    from spades_for_blackbird_tpu.parallel import mesh as jmesh
    m = jmesh.make_mesh(2)
    codes, lengths = _vertex_reads()
    sc, sl = jmesh.shard_reads(m, codes, lengths)
    kk, cc, nn, dropped = jx.make_sharded_counter(
        m, K + 1, capacity_factor=6.0)(sc, sl)
    vk, om, im, vn, vdrop = jc.make_sharded_vertex_builder(
        m, K, capacity_factor=6.0)(kk, nn)
    assert int(np.asarray(dropped).sum()) == 0
    assert int(np.asarray(vdrop).sum()) == 0
    for rank, (rows, counts) in enumerate(_jax_shards(kk, nn, [cc])):
        np.testing.assert_array_equal(world2[rank]["kp1"]["kmers"], rows)
        np.testing.assert_array_equal(world2[rank]["kp1"]["counts"], counts)
    for rank, (rows, o, i) in enumerate(_jax_shards(vk, vn, [om, im])):
        got = world2[rank]["vertex"]
        np.testing.assert_array_equal(got["kmers"], rows)
        np.testing.assert_array_equal(got["out_mask"], o)
        np.testing.assert_array_equal(got["in_mask"], i)
    # gathered: the single-device vertex table, on every rank
    kp1 = counter.count_kmers(_t(codes), _t(lengths), K + 1)
    want = _vt_rows(extension.build_vertex_table(kp1, K))
    for r in world2:
        for f in ("kmers", "out_mask", "in_mask", "num"):
            np.testing.assert_array_equal(r["gathered_vertex"][f], want[f])


def test_sharded_graph_builder_canonical(world2):
    from spades_for_blackbird_tpu.io import fasta as jfasta
    from spades_for_blackbird_tpu.parallel import condense_dist as jcd
    from spades_for_blackbird_tpu.parallel import construction as jc
    from spades_for_blackbird_tpu.parallel import kmer_exchange as jx
    from spades_for_blackbird_tpu.parallel import mesh as jmesh
    codes, lengths = _graph_reads()
    m = jmesh.make_mesh(2)
    sc, sl = jmesh.shard_reads(m, codes, lengths)
    kk, cc, nn, _ = jx.make_sharded_counter(m, K + 1,
                                            capacity_factor=6.0)(sc, sl)
    vk, om, im, vn, _ = jc.make_sharded_vertex_builder(
        m, K, capacity_factor=6.0)(kk, nn)
    g_jax, qdrop = jcd.make_sharded_graph_builder(
        m, K, capacity_factor=6.0)(kk, cc, nn, vk, om, im, vn)
    assert int(np.asarray(qdrop).sum()) == 0
    want = canon(jfasta.graph_contigs(g_jax, min_length=0))
    single = canon(fasta.graph_contigs(_single_graph(codes, lengths), 0))
    assert want == single
    for r in world2:
        assert r["contigs"] == want
    # the same graph on every rank
    for f, a in world2[0]["graph"].items():
        np.testing.assert_array_equal(world2[1]["graph"][f], a, err_msg=f)


def test_contract_chains_sharded_matches(world2):
    from spades_for_blackbird_tpu.graph.pointer_jump import (
        contract_chains as jax_contract)
    for i, (seed, cyc) in enumerate(CHAIN_CASES):
        succ, conj, valid = _chain_case(1024, seed, cyc)
        single = pointer_jump.contract_chains(_t(succ), _t(conj), _t(valid))
        jx = jax_contract(succ.astype(np.int32), conj.astype(np.int32),
                          valid)
        for f in single._fields:
            got = np.concatenate([r["chains"][i][f] for r in world2])
            np.testing.assert_array_equal(got, getattr(single, f).numpy(),
                                          err_msg=f)
            np.testing.assert_array_equal(got, np.asarray(getattr(jx, f)),
                                          err_msg=f)


def test_world_one_equals_single_device(world1):
    """At world size 1 every table, the graph's arrays and the chains
    equal the single-device functions' bits."""
    codes, lengths = _count_reads()
    single = _table_rows(counter.count_kmers(_t(codes), _t(lengths), K))
    for f in ("kmers", "counts", "num"):
        np.testing.assert_array_equal(world1["count"][f], single[f])
    codes, lengths = _vertex_reads()
    kp1 = counter.count_kmers(_t(codes), _t(lengths), K + 1)
    want = _vt_rows(extension.build_vertex_table(kp1, K))
    for f in ("kmers", "out_mask", "in_mask", "num"):
        np.testing.assert_array_equal(world1["vertex"][f], want[f])
    g = interop.graph_to_numpy(_single_graph(*_graph_reads()))
    n = int(g["num_edges"])
    assert int(world1["graph"]["num_edges"]) == n
    for f in ("seq_start", "seq_len", "cov", "start_v", "end_v", "conj",
              "alive", "flank"):
        np.testing.assert_array_equal(world1["graph"][f][:n], g[f][:n],
                                      err_msg=f)
    used = int((g["seq_start"][:n] + g["seq_len"][:n]).max())
    np.testing.assert_array_equal(world1["graph"]["seq_flat"][:used],
                                  g["seq_flat"][:used])
    for i, (seed, cyc) in enumerate(CHAIN_CASES):
        single = pointer_jump.contract_chains(*map(_t, _chain_case(
            1024, seed, cyc)))
        for f in single._fields:
            np.testing.assert_array_equal(world1["chains"][i][f],
                                          getattr(single, f).numpy())


def test_rank_without_reads(world2):
    """One read at world size 2: rank 1 counts only padding, and both
    ranks build the read's graph."""
    codes, lengths = _count_reads()
    want = canon(fasta.graph_contigs(
        _single_graph(codes[:1], lengths[:1]), 0))
    assert [r["one_read"]["contigs"] for r in world2] == [want, want]
    assert sum(r["one_read"]["num"] for r in world2) == 80 - K
