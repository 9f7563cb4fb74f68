"""The PyTorch port's paired repeat resolution vs the JAX package's:
``repeat_resolution_multi`` on one graph with one paired-end library,
with a paired-end and a mate-pair library, and with a library whose
insert size cannot be estimated; the contigs, scaffolds, paths, library
data and scaffold graph must be the same."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from spades_for_blackbird_tpu.path_extend import (  # noqa: E402
    resolver as jresolver)
from spades_for_blackbird_tpu.pipeline import (  # noqa: E402
    assemble as jassemble)
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import interop  # noqa: E402
from spades_for_blackbird_tpu_torch.graph import host  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.path_extend import (  # noqa: E402
    resolver)
from spades_for_blackbird_tpu_torch.pipeline import assemble  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import simulate  # noqa: E402

GENOME = simulate.random_genome(16000, seed=51,
                                repeats=[(500, 2), (300, 3)])


@pytest.fixture(autouse=True)
def _default_reference_logger():
    """The JAX package logs through one process-wide logger, and a CLI
    test run earlier in the same worker can leave a writer on it whose
    file is closed. These tests start from the default configuration."""
    jlogger.configure()


def _library(n_pairs, insert, seed):
    r1, _, r2, _ = simulate.simulate_paired_reads(
        GENOME, n_pairs, read_len=100, insert_mean=insert,
        insert_sd=insert / 12, error_rate=0.002, seed=seed)
    return r1, r2


def _arrays(r1, r2, kind):
    c1, l1 = dna.encode_reads(r1)
    c2, l2 = dna.encode_reads(r2)
    return c1, l1, c2, l2, kind


@pytest.fixture(scope="module")
def graphs():
    """The JAX package's k = 33 graph of a 16 kb genome with a 500 bp
    repeat in 2 copies and a 300 bp one in 3, in both packages."""
    r1, r2 = _library(3200, 300, seed=52)
    codes, lengths = dna.encode_reads(r1 + r2)
    jlogger.configure()  # see _default_reference_logger
    mp = pytest.MonkeyPatch()
    mp.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    try:
        jg = jassemble.assemble_single_k(codes, lengths, 33).graph
    finally:
        mp.undo()
        jlogger.configure()
    g = interop.graph_from_numpy(
        interop.fields_of(jg, interop.GRAPH_FIELDS), jg.k, "cpu")
    return jg, g


def _both(graphs, libs, monkeypatch):
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    jg, g = graphs
    outs = []
    for run, graph, extra in ((jassemble.repeat_resolution_multi, jg, {}),
                              (assemble.repeat_resolution_multi, g,
                               {"device": "cpu"})):
        lib_data, sg, paths = [], {}, {}
        contigs, scaffolds = run(graph, libs, with_scaffolds=True,
                                 lib_data_out=lib_data,
                                 scaffold_graph_out=sg, paths_out=paths,
                                 **extra)
        tsv = sg["graph"].to_tsv() if "graph" in sg else None
        outs.append(dict(contigs=contigs, scaffolds=scaffolds,
                         lib_data=lib_data, paths=paths, sg=tsv))
    jlogger.configure()
    return outs


def test_one_paired_end_library(graphs, monkeypatch):
    theirs, ours = _both(graphs, [_arrays(*_library(3200, 300, 53), "pe")],
                         monkeypatch)
    assert ours == theirs
    assert ours["lib_data"][0]["pairs_used"] > 1000
    # path extension went through the repeats: fewer contigs than edges
    alive = host.host_view(graphs[1]).mask
    assert len(ours["contigs"]) < int(alive.sum()) // 2
    assert any(len(p) > 1 for p in ours["paths"]["contigs"])


def test_paired_end_and_mate_pair_libraries(graphs, monkeypatch):
    libs = [_arrays(*_library(2400, 300, 54), "pe"),
            _arrays(*_library(1200, 2500, 55), "mp")]
    theirs, ours = _both(graphs, libs, monkeypatch)
    assert ours == theirs
    assert [d["kind"] for d in ours["lib_data"]] == ["pe", "mp"]
    assert ours["sg"] is not None


def test_library_without_an_insert_size(graphs, monkeypatch):
    """Reads from nowhere in the genome: no pair maps, the insert size is
    not estimated (count 0), no library is left, and the graph's edges
    come out as they are."""
    rng = np.random.default_rng(56)
    r1 = ["".join(rng.choice(list("ACGT"), 100)) for _ in range(300)]
    r2 = ["".join(rng.choice(list("ACGT"), 100)) for _ in range(300)]
    theirs, ours = _both(graphs, [_arrays(r1, r2, "pe")], monkeypatch)
    assert ours == theirs
    assert ours["lib_data"][0]["pairs_used"] == 0
    assert ours["contigs"] == ours["scaffolds"]


def test_path_sets_cross_between_the_packages(graphs):
    jg, g = graphs
    seqs = jresolver.paths_to_contigs(
        jg, jresolver.PathSet(paths=[[0], [2, 4]]), with_paths=True)
    ps = interop.path_set_from_numpy([p for _, _, p in seqs])
    assert interop.path_set_to_numpy(ps) == [p for _, _, p in seqs]
    assert resolver.paths_to_contigs(g, ps, with_paths=True) == seqs


def test_without_a_card_repeat_resolution_refuses(graphs):
    if torch.cuda.is_available():
        pytest.skip("shows the refusal on a machine without a card")
    _, g = graphs
    with pytest.raises(RuntimeError, match="CUDA card"):
        assemble.repeat_resolution_multi(
            g, [_arrays(*_library(10, 300, 57), "pe")])
    # the long-read branch runs where it is asked to: with no library
    # and no long read, the contigs pass through as without it
    no_reads = (np.zeros((0, 1), np.uint8), np.zeros(0, np.int32))
    assert assemble.repeat_resolution_multi(
        g, [], long_reads=no_reads, device="cpu") == \
        assemble.repeat_resolution_multi(g, [], device="cpu")
