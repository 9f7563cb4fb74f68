"""The benchmark's frozen simulators and cost functions against the
originals they were copied from."""

from __future__ import annotations

import numpy as np

import chip_smoke
from portbench import kernels, simulate
from spades_for_blackbird_tpu_torch.utils import simulate as port_simulate


def test_random_genome_is_the_programs():
    for seed, gc in ((7, 0.5), (21, 0.4)):
        kw = dict(repeats=[(200, 3), (70, 4)], gc=gc)
        assert (simulate.random_genome(20_000, seed, **kw)
                == port_simulate.random_genome(20_000, seed=seed, **kw))


def test_paired_codes_are_chip_smokes():
    genome = simulate.random_genome(20_000, 7, repeats=[(400, 2)])
    ours = simulate.paired_codes(genome, 3000, 100, 300.0, 25.0, 0.002, 8)
    theirs = chip_smoke.paired_codes(genome, 3000, 100, 300.0, 25.0, 0.002,
                                     8)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_seed_draws_the_reads_and_the_config_the_genome():
    cfg = {"pairs": 500,
           "sources": [{"name": "c", "length": 5000, "seed": 7}],
           "library": {"read_len": 100, "insert_mean": 300.0,
                       "insert_sd": 25.0, "error_rate": 0.002}}
    big = 2**31 + 12345
    a, b, c = (simulate.simulate(cfg, s) for s in (big, big, 3))
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.quals, b.quals)
    assert a.sources == c.sources == {
        "c": simulate.random_genome(5000, 7)}
    assert not np.array_equal(a.codes, c.codes)
    want = simulate.paired_codes(a.sources["c"], 500, 100, 300.0, 25.0,
                                 0.002, np.random.default_rng(
                                     simulate.seed_for(big, 1)))
    for x, y in zip((a.codes, a.quals, a.truth), want):
        np.testing.assert_array_equal(x, y)


def test_fastq_text_round_trips_through_the_programs_reader(tmp_path):
    from spades_for_blackbird_tpu_torch.io import fastq
    cfg = {"pairs": 700,
           "sources": [{"name": "c", "length": 5000, "seed": 7}],
           "library": {"read_len": 100, "insert_mean": 300.0,
                       "insert_sd": 25.0, "error_rate": 0.002}}
    reads = simulate.simulate(cfg, 9)
    paths = simulate.write_mates(reads, str(tmp_path))
    b1, b2 = fastq.load_paired_reads(*paths, with_quals=True)
    np.testing.assert_array_equal(b1.codes, reads.codes[:700])
    np.testing.assert_array_equal(b2.quals, reads.quals[700:])


def test_kmer_bytes_are_the_smokes_1516_mb():
    assert kernels.kmer_bytes(1_840_000, 100, 56) == 1_516_160_000
    for shape in ((1_840_000, 100, 56, False), (1_840_000, 100, 22, True),
                  (262_144, 150, 22, False), (3, 4096, 128, True)):
        ours = kernels.kmer_bound(*shape)
        theirs = chip_smoke.bound_of(*shape)
        assert ours[1:] == theirs[1:]
        assert abs(ours[0] * 1e3 - theirs[0]) < 1e-9 * theirs[0]
