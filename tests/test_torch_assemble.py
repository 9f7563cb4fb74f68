"""The PyTorch port's single-K slice vs the JAX package, and the port's
independence from JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: more intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

from spades_for_blackbird_tpu.pipeline import (  # noqa: E402
    assemble as jassemble)
from spades_for_blackbird_tpu.simplify import runner as jrunner  # noqa: E402
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import interop  # noqa: E402
from spades_for_blackbird_tpu_torch.io import fasta  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import assemble  # noqa: E402
from spades_for_blackbird_tpu_torch.simplify import runner  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import assess, simulate  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Contig coverages are float32 averages merged by recondense and bulge
# projection; the port takes those sums in another order than XLA, so
# they may differ in the last bits. Sequences must be identical.
COV_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _default_reference_logger():
    """The JAX package logs through one process-wide logger, and a CLI
    test run earlier in the same worker can leave a writer on it whose
    file is closed. These tests start from the default configuration."""
    jlogger.configure()


def _genome_reads(seed=11, size=6000):
    genome = simulate.random_genome(size, seed=seed, repeats=[(300, 2)])
    r1, _, r2, _ = simulate.simulate_paired_reads(
        genome, int(30 * size / 120), read_len=60, insert_mean=200,
        insert_sd=15, error_rate=0.003, seed=seed + 1)
    codes, lengths = dna.encode_reads(r1 + r2)
    return genome, codes, lengths


def canonical(contigs):
    return sorted((min(s, dna.revcomp_str(s)), c) for s, c in contigs)


@pytest.mark.parametrize("k", [21, 33])
def test_single_k_slice_matches_jax(k, monkeypatch):
    # the JAX package would run its sharded branch on the 8 virtual
    # CPU devices of the test session; the port mirrors the single-
    # device branch
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    genome, codes, lengths = _genome_reads()
    res = assemble.assemble_single_k(codes, lengths, k, device="cpu")
    jres = jassemble.assemble_single_k(codes, lengths, k)
    a, b = canonical(res.contigs), canonical(jres.contigs)
    assert [s for s, _ in a] == [s for s, _ in b]
    np.testing.assert_allclose([c for _, c in a], [c for _, c in b],
                               rtol=COV_RTOL)
    assert vars(res.genomic_info) == vars(jres.genomic_info)
    assert res.stats["edges"] == jres.stats["edges"]
    report = assess.assess([s for s, _ in res.contigs], genome)
    assert report.misassemblies == 0 and report.genome_fraction > 0.9


def test_contigs_fasta_and_min_length(tmp_path):
    _, codes, lengths = _genome_reads(seed=5, size=3000)
    res = assemble.assemble_single_k(torch.from_numpy(codes),
                                     torch.from_numpy(lengths), 21,
                                     min_contig_length=200, device="cpu")
    assert res.contigs and all(len(s) >= 200 for s, _ in res.contigs)
    path = tmp_path / "contigs.fasta"
    fasta.write_contigs_fasta(str(path), res.contigs)
    text = path.read_text().splitlines()
    assert text[0].startswith(f">NODE_1_length_{len(res.contigs[0][0])}_cov_")
    assert "".join(ln for ln in text[1:] if not ln.startswith(">")) \
        .startswith(res.contigs[0][0][:60])
    with_edges = fasta.graph_contigs(res.graph, min_length=200,
                                     with_edges=True)
    assert [(s, c) for s, c, _ in with_edges] == res.contigs


@pytest.mark.parametrize("option", [
    {"cfg": runner.SimplifyConfig(mfec_enabled=True)},
    {"cfg": runner.SimplifyConfig(mfec_enabled=True, red_enabled=True,
                                  superbubble_enabled=True)},
])
def test_unported_options_raise(option, monkeypatch):
    """The options the port once refused (the max-flow EC remover, alone
    and beside red and superbubbles) now run, and give the JAX package's
    contigs."""
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    _, codes, lengths = _genome_reads()
    res = assemble.assemble_single_k(codes, lengths, 21, device="cpu",
                                     **option)
    jcfg = jrunner.SimplifyConfig(**{
        f.name: getattr(option["cfg"], f.name)
        for f in dataclasses.fields(option["cfg"])})
    jres = jassemble.assemble_single_k(codes, lengths, 21, cfg=jcfg)
    a, b = canonical(res.contigs), canonical(jres.contigs)
    assert [s for s, _ in a] == [s for s, _ in b]
    np.testing.assert_allclose([c for _, c in a], [c for _, c in b],
                               rtol=COV_RTOL)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_default_device_is_the_card(as_tensor):
    """Without ``device`` the assembly runs on the card, whatever holds
    the reads; where there is none it raises and does not take the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("shows the raise on a machine without a card")
    codes, lengths = dna.encode_reads(["ACGT" * 15])
    if as_tensor:
        codes, lengths = torch.from_numpy(codes), torch.from_numpy(lengths)
    with pytest.raises(RuntimeError, match="CUDA card"):
        assemble.assemble_single_k(codes, lengths, 21)


def test_interop_graph_round_trip():
    _, codes, lengths = _genome_reads(seed=8, size=2000)
    g = assemble.assemble_single_k(codes, lengths, 21, device="cpu").graph
    arrays = interop.graph_to_numpy(g)
    g2 = interop.graph_from_numpy(arrays, g.k)
    back = interop.graph_to_numpy(g2)
    for name in interop.GRAPH_FIELDS:
        assert np.array_equal(np.asarray(arrays[name]),
                              np.asarray(back[name])), name


NO_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.modules["spades_for_blackbird_tpu"] = None
import numpy as np
import spades_for_blackbird_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]  # that one runs the CLI
for name in names:
    importlib.import_module(name)
for name in ("cli", "native", "pipeline.stages", "pipeline.spades_stages",
             "pipeline.config", "io.fastq", "io.gfa", "io.fastg",
             "io.read_store", "utils.membudget", "path_extend.resolver",
             "hammer.correct", "hammer.bayes", "hammer.cluster",
             "hammer.ionhammer"):
    assert pkg.__name__ + "." + name in sys.modules, name
from spades_for_blackbird_tpu_torch import cli
from spades_for_blackbird_tpu_torch.io import fastq
from spades_for_blackbird_tpu_torch.ops import dna
from spades_for_blackbird_tpu_torch.pipeline import assemble
from spades_for_blackbird_tpu_torch.utils import simulate
genome = simulate.random_genome(1500, seed=1)
r1, _, r2, _ = simulate.simulate_paired_reads(genome, 300, read_len=60,
                                              insert_mean=200, insert_sd=10,
                                              error_rate=0.0, seed=2)
codes, lengths = dna.encode_reads(r1 + r2)
res = assemble.assemble_single_k(codes, lengths, 21, device="cpu")
assert res.contigs, "no contigs"
out = sys.argv[1]
fastq.write_reads_fastq(out + "/reads.fq", codes, lengths)
assert cli.main(["-s", out + "/reads.fq", "-o", out + "/out", "-k", "21",
                 "--only-assembler", "--device", "cpu"]) == 0
assert fastq.read_sequences(out + "/out/contigs.fasta")[1] == \
    [s for s, _ in res.contigs]
# the default command: error correction, then the rung
assert cli.main(["-s", out + "/reads.fq", "-o", out + "/default", "-k", "21",
                 "--device", "cpu"]) == 0
assert fastq.read_sequences(out + "/default/contigs.fasta")[1]
for banned in ("jax", "spades_for_blackbird_tpu"):
    assert not any(m == banned or m.startswith(banned + ".")
                   for m in sys.modules if sys.modules[m] is not None), banned
print("modules", len(names), "contigs", len(res.contigs))
"""


def test_port_never_imports_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", NO_JAX, str(tmp_path)],
                          cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "contigs" in proc.stdout
