"""The PyTorch port's plasmid modes vs the JAX package's: every public
function of ``models/plasmid.py`` on the JAX tests' own graphs
(tests/test_modes.py:35-123), ``--plasmid``, ``--metaplasmid`` and
``--metaviral`` through both command lines on that file's reads
(:125-152, :216-236), and where metaplasmid's ``contigs.fasta`` comes
from.

Every function is handed the same graph (built by the JAX package,
carried over with ``interop``). Integers and sequences must be equal;
coverage is held at rtol 1e-5, since recondense sums float32 coverage in
another order than XLA. The command lines' output files must be
byte-identical.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import naive_debruijn as nd  # noqa: E402
from spades_for_blackbird_tpu import cli as jcli  # noqa: E402
from spades_for_blackbird_tpu.graph import construct as jconstruct  # noqa: E402
from spades_for_blackbird_tpu.graph import graph as jgraph  # noqa: E402
from spades_for_blackbird_tpu.models import plasmid as jplasmid  # noqa: E402
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import cli, interop  # noqa: E402
from spades_for_blackbird_tpu_torch.graph.graph import Graph  # noqa: E402
from spades_for_blackbird_tpu_torch.models import plasmid  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

K = 15
COV_RTOL = 1e-5  # float32 sums in another order than XLA's
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _reference_logger_reset(monkeypatch):
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    jlogger.configure()
    yield
    # the JAX command line leaves a writer on its closed log file
    jlogger.configure()


def random_dna(n, seed):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), size=n))


def graph_of(reads):
    codes, lengths = dna.encode_reads(reads)
    return jconstruct.graph_from_reads(codes, lengths, K)


# tests/test_modes.py's fixtures
def circle_graph():
    core = random_dna(400, 1)
    wrap = core + core[:60]
    return graph_of([wrap[i:i + 50] for i in range(0, len(wrap) - 50 + 1, 3)])


def plasmid_graph():
    chrom, plas = random_dna(3000, 2), random_dna(1500, 3)
    wrap = plas + plas[:60]
    reads = [chrom[i:i + 50] for i in range(0, 3000 - 50, 2)]
    reads += [wrap[i:i + 50] for i in range(0, len(wrap) - 50, 1)]
    return graph_of(reads)


def tiny_circle_graph():
    tiny = random_dna(350, 9)
    wrap = tiny + tiny[:60]
    return graph_of([wrap[i:i + 50] for i in range(0, len(wrap) - 50, 1)])


def lone_plasmid_graph():
    plas = random_dna(2000, 5)
    wrap = plas + plas[:60]
    return graph_of([wrap[i:i + 50] for i in range(0, len(wrap) - 50, 1)])


FIXTURES = {"circle": circle_graph, "plasmid": plasmid_graph,
            "tiny_circle": tiny_circle_graph,
            "lone_plasmid": lone_plasmid_graph}


def port_graph(jg):
    return interop.graph_from_numpy(
        interop.fields_of(jg, interop.GRAPH_FIELDS), jg.k)


def assert_same(ours, theirs, where="result"):
    """Port result == JAX result: graphs field by field, floats at
    rtol COV_RTOL, everything else exactly."""
    if isinstance(ours, Graph):
        a = interop.graph_to_numpy(ours)
        b = interop.fields_of(theirs, interop.GRAPH_FIELDS)
        assert ours.capacity == theirs.capacity, where
        for name in ("seq_flat", "seq_start", "seq_len", "start_v", "end_v",
                     "conj", "alive", "num_edges"):
            assert np.array_equal(a[name], b[name]), f"{where}.{name}"
        np.testing.assert_allclose(a["cov"], b["cov"], rtol=COV_RTOL,
                                   atol=0.0, err_msg=where)
    elif isinstance(ours, (tuple, list)):
        assert isinstance(theirs, (tuple, list)), where
        assert len(ours) == len(theirs), where
        for i, (x, y) in enumerate(zip(ours, theirs)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(ours, np.ndarray) and ours.dtype.kind == "f":
        np.testing.assert_allclose(ours, theirs, rtol=COV_RTOL, err_msg=where)
    elif isinstance(ours, np.ndarray):
        assert np.array_equal(ours, theirs), where
    elif isinstance(ours, float):
        assert ours == pytest.approx(float(theirs), rel=COV_RTOL), where
    else:
        assert ours == theirs, where


def _compacted(mod, jg):
    """(graph, v_space) of the compacted fixture, in ``mod``'s package."""
    g, v_space = jgraph.compact_graph(jg)
    return (port_graph(g) if mod is plasmid else g), v_space


# name: (fixture, fn(mod, graph of that package) -> result)
CASES = {
    "components": ("plasmid", lambda m, g: m._components(
        _compacted(m, g)[0])),
    "remove_long_genomic_edges": ("plasmid", lambda m, g: m.
                                  remove_long_genomic_edges(
                                      *_compacted(m, g), m.PlasmidParams())),
    "remove_long_genomic_edges_external": (
        "plasmid", lambda m, g: m.remove_long_genomic_edges(
            *_compacted(m, g), m.PlasmidParams(), external_cov=20.0)),
    "plasmid_simplify": ("plasmid", lambda m, g: m.plasmid_simplify(
        *_compacted(m, g), 1000)),
    "plasmid_simplify_forbidden": ("plasmid", lambda m, g: m.plasmid_simplify(
        *_compacted(m, g), 1000,
        forbidden=m.tip_end_vertices(_compacted(m, g)[0]))),
    "coverage_filter": ("plasmid", lambda m, g: m.coverage_filter(
        *_compacted(m, g), 20.0)),
    "filter_small_components": ("plasmid", lambda m, g: m.
                                filter_small_components(
                                    *_compacted(m, g), m.PlasmidParams(),
                                    20.0, {})),
    "run_isolated_pipeline": ("plasmid", lambda m, g: m.run_isolated_pipeline(
        port_graph(g) if m is plasmid else g)),
    "run_isolated_pipeline_tiny": ("tiny_circle", lambda m, g: m.
                                   run_isolated_pipeline(
                                       port_graph(g) if m is plasmid
                                       else g)),
    "tip_end_vertices": ("plasmid", lambda m, g: m.tip_end_vertices(
        _compacted(m, g)[0])),
    "suspicious_components": ("lone_plasmid", lambda m, g: m.
                              suspicious_components(
                                  _compacted(m, g)[0], 10.0)),
    "run_meta_pipeline": ("plasmid", lambda m, g: m.run_meta_pipeline(
        _compacted(m, g)[0], 30.0,
        forbidden=m.tip_end_vertices(_compacted(m, g)[0]))),
    "metaplasmid_iterate": ("lone_plasmid", lambda m, g: m.
                            metaplasmid_iterate(
                                port_graph(g) if m is plasmid else g)),
    "metaplasmid_iterate_two": ("plasmid", lambda m, g: m.metaplasmid_iterate(
        port_graph(g) if m is plasmid else g)),
    "remove_chromosomal": ("plasmid", lambda m, g: m.remove_chromosomal(
        port_graph(g) if m is plasmid else g, 1000, 0.3)),
    "remove_chromosomal_single_shot": (
        "plasmid", lambda m, g: m.remove_chromosomal(
            port_graph(g) if m is plasmid else g, 1000, 0.3,
            iterative=False)),
    "circular_contigs": ("circle", lambda m, g: m.circular_contigs(
        port_graph(g) if m is plasmid else g)),
    "circular_contigs_after_removal": (
        "plasmid", lambda m, g: m.circular_contigs(m.remove_chromosomal(
            port_graph(g) if m is plasmid else g))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plasmid_function_matches_jax(name):
    fixture, fn = CASES[name]
    jg = FIXTURES[fixture]()
    assert_same(fn(plasmid, jg), fn(jplasmid, jg), name)


def test_plasmid_params_and_writers_match_jax(tmp_path):
    assert plasmid.PlasmidParams() == plasmid.PlasmidParams(
        **vars(jplasmid.PlasmidParams()))
    jg = plasmid_graph()
    contigs = jplasmid.circular_contigs(jplasmid.remove_chromosomal(jg))
    assert any(c for _, _, c in contigs)
    rounds = jplasmid.metaplasmid_iterate(lone_plasmid_graph())
    cut, _, susp = next(r for r in rounds if r[2])
    for write, jwrite, args in (
            (plasmid.write_plasmid_fasta, jplasmid.write_plasmid_fasta,
             (contigs,)),
            (plasmid.write_component_fasta, jplasmid.write_component_fasta,
             (cut, susp))):
        ours, theirs = tmp_path / "ours.fasta", tmp_path / "theirs.fasta"
        write(str(ours), *args)
        jwrite(str(theirs), *args)
        assert ours.read_bytes() == theirs.read_bytes() and \
            ours.read_bytes()


def _single_end(path, chrom_seed, plas_seed, chrom_step=3):
    """tests/test_modes.py:125-152 and :216-236: a 4 kb chromosome at
    20x (a 60 bp read every ``chrom_step`` bases) and a 2 kb circular
    plasmid at 60x."""
    chrom = random_dna(4000, chrom_seed)
    plas = random_dna(2000, plas_seed)
    wrap = plas + plas[:70]
    reads = [chrom[i:i + 60] for i in range(0, len(chrom) - 60, chrom_step)]
    reads += [wrap[i:i + 60] for i in range(0, len(wrap) - 60, 1)]
    simulate.write_fastq(path, reads, ["I" * len(r) for r in reads])
    return chrom, plas


# run: (mode, chromosome seed, plasmid seed, chromosome read step); the
# thin run puts the chromosome at 6x, under every cutoff's 1.3x margin,
# so that no cutoff offers it as a candidate
RUNS = {"plasmid": ("plasmid", 21, 22, 3),
        "metaplasmid": ("metaplasmid", 21, 22, 3),
        "metaviral": ("metaviral", 41, 42, 3),
        "metaplasmid_thin": ("metaplasmid", 21, 22, 10)}


@pytest.fixture(scope="module")
def plasmid_runs(tmp_path_factory):
    """Each run through both command lines at -k 21: {run: (mode,
    chromosome, plasmid, the port's output, the JAX package's)}."""
    root = tmp_path_factory.mktemp("plasmid")
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
        for name, (mode, *data) in RUNS.items():
            fq = str(root / f"{name}.fq")
            chrom, plas = _single_end(fq, *data)
            argv = ["-s", fq, "-k", "21", f"--{mode}", "--only-assembler",
                    "--checkpoints", "none"]
            port, theirs = root / name / "port", root / name / "jax"
            assert cli.main(argv + ["-o", str(port)] + CPU) == 0
            try:
                assert jcli.main(argv + ["-o", str(theirs)]) == 0
            finally:
                jlogger.configure()
            runs[name] = (mode, chrom, plas, port, theirs)
    return runs


@pytest.mark.parametrize("run", list(RUNS))
def test_plasmid_command_lines_match_jax(plasmid_runs, run):
    mode, _, _, port, theirs = plasmid_runs[run]
    names = sorted(n for n in os.listdir(theirs) if n != "spades.log"
                   and (theirs / n).is_file())
    assert sorted(n for n in os.listdir(port) if n != "spades.log"
                  and (port / n).is_file()) == names
    assert "contigs.circular.fasta" in names
    assert ("contigs.linears.fasta" in names) == (mode == "metaviral")
    if mode != "plasmid":
        assert any(n.startswith("components_") for n in names)
    for name in names:
        assert (port / name).read_bytes() == (theirs / name).read_bytes(), \
            name
    log = (port / "spades.log").read_text()
    assert f"mode: {mode}" in log and "chromosome removal:" in log


def _fasta(path):
    return ["".join(rec.splitlines()[1:])
            for rec in path.read_text().split(">")[1:]]


def test_metaplasmid_contigs_are_the_whole_community(plasmid_runs):
    """Pins a reference-side behaviour: in --metaplasmid (and
    --metaviral) the second phase reassembles all reads and replaces the
    graph chromosome removal left, so ``contigs.fasta`` (and the circular
    output) come from the whole community; only ``components_*.fasta``
    holds the plasmid candidates alone. Here chromosome removal keeps
    the plasmid alone, and contigs.fasta holds the chromosome too."""
    _, chrom, plas, port, theirs = plasmid_runs["metaplasmid_thin"]
    ring = plas + plas
    for out in (port, theirs):
        log = (out / "spades.log").read_text()
        assert "chromosome removal: 1 candidate edges left" in log
        assert "second phase:" in log
        components = [s for p in sorted(out.glob("components_*.fasta"))
                      for s in _fasta(p)]
        assert components
        assert all(s[:60] in ring or nd.rc(s)[:60] in ring
                   for s in components)
        contigs = _fasta(out / "contigs.fasta")
        assert any(s[:60] in chrom or nd.rc(s)[:60] in chrom
                   for s in contigs if len(s) > 1000)
        assert any(s[:60] in ring or nd.rc(s)[:60] in ring
                   for s in contigs)
