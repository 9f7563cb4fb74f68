"""The coverage fit on the host worker thread: each rung joins it once,
where its answer is first read; the pre-simplify save it is joined in is
what ``np.savez_compressed`` writes; a fit that raises fails the rung;
``--cov-cutoff auto`` still filters with the fit's bound. The answer is
the JAX package's throughout."""

import json
import os
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: more intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from spades_for_blackbird_tpu.kmers import counter as jcounter  # noqa: E402
from spades_for_blackbird_tpu.kmers import (  # noqa: E402
    coverage_model as jcm)
from spades_for_blackbird_tpu.utils import logger as jlogger  # noqa: E402
from spades_for_blackbird_tpu_torch import interop  # noqa: E402
from spades_for_blackbird_tpu_torch.kmers import coverage_model  # noqa: E402
from spades_for_blackbird_tpu_torch.ops import dna  # noqa: E402
from spades_for_blackbird_tpu_torch.pipeline import assemble  # noqa: E402
from spades_for_blackbird_tpu_torch.utils import (  # noqa: E402
    simulate, timetrace)

KS = [21, 33]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _single_device_reference(monkeypatch):
    """The JAX package takes its single-device branch and logs through
    its default configuration."""
    monkeypatch.setenv("SFB_TPU_FORCE_SINGLE_DEVICE", "1")
    jlogger.configure()


@pytest.fixture(scope="module")
def reads():
    genome = simulate.random_genome(4000, seed=21, repeats=[(300, 2)])
    r1, _, r2, _ = simulate.simulate_paired_reads(
        genome, 1000, read_len=60, insert_mean=200, insert_sd=15,
        error_rate=0.003, seed=22)
    return dna.encode_reads(r1 + r2)


@pytest.fixture(scope="module")
def jax_ginfo(reads):
    """k -> the JAX package's genomic info of the reads' (k+1)-mer
    spectrum."""
    codes, lengths = reads
    fitted = {}

    def at(k) -> dict:
        if k not in fitted:
            t = jcounter.count_kmers(jnp.asarray(codes), jnp.asarray(lengths),
                                     k + 1)
            fitted[k] = vars(jcm.fit_coverage_model_hist(
                jcm.count_spectrum_device(t.counts, t.num)))
        return dict(fitted[k])
    return at


@pytest.mark.parametrize("reader", ["save", "simplify", "uneven"])
def test_fit_runs_off_the_rung_and_is_joined_once(reads, jax_ginfo, tmp_path,
                                                  reader):
    """Every rung's fit runs on another thread than the rung and is
    joined once on the rung's thread: inside the pre-simplify save with
    a phase directory (two rungs, the second fed the first's contigs),
    right before simplify without one, and after the graph's bound under
    uneven depth. The answer is the JAX package's."""
    codes, lengths = reads
    prev: list[str] = []
    for k in KS if reader == "save" else KS[:1]:
        timetrace.enable()
        try:
            with timetrace.scope(f"stage:k{k}"):
                res = assemble.assemble_single_k(
                    codes, lengths, k, device="cpu", extra_sequences=prev,
                    phase_dir=(str(tmp_path / "phases") if reader == "save"
                               else None),
                    uneven_depth=reader == "uneven")
        finally:
            timetrace.disable()
        prev = [s for s, _ in res.contigs]
        events = timetrace.events()
        by_id = {ev["id"]: ev for ev in events}
        spans = {}
        for ev in events:
            spans.setdefault(ev["name"], []).append(ev)
        (stage,), (em,), (fit,) = (spans[f"stage:k{k}"], spans["coverage_em"],
                                   spans["coverage_model_fit"])
        (wait,), (simplify,) = spans["coverage_wait"], spans["simplify"]
        assert em["tid"] == fit["tid"] != stage["tid"]
        assert by_id[em["parent"]] is fit
        assert em["args"]["counts"]["fit_evaluations"] > 0
        assert wait["tid"] == stage["tid"]
        counts = wait["args"]["counts"]
        assert counts["fit_joined"] == 1
        assert set(counts) <= {"fit_joined", "fit_ready"}
        parent = "phase_checkpoint" if reader == "save" else f"stage:k{k}"
        assert by_id[wait["parent"]]["name"] == parent
        assert wait["ts"] + wait["dur"] <= simplify["ts"]
        assert fit["ts"] + fit["dur"] <= wait["ts"] + wait["dur"] + 1
        expected = jax_ginfo(k)
        if reader == "uneven":   # the bound is the graph's
            expected["ec_bound"] = res.genomic_info.ec_bound
        assert vars(res.genomic_info) == expected
    if reader == "save":
        assert os.listdir(tmp_path / "phases") == []


def test_presimplify_save_is_what_savez_compressed_writes(reads, jax_ginfo,
                                                          tmp_path):
    """Joined inside the save, the pending fit's answer goes in last; the
    zip holds what ``np.savez_compressed`` writes of the same arrays,
    member for member, in the same order."""
    codes, lengths = reads
    k = KS[0]
    t = torch.from_numpy
    g, v_space, fit = assemble._construct_pending(
        t(codes), t(lengths), k, 1, None, True, CPU)
    ginfo = assemble._save_phase_presimplify(str(tmp_path / "ours"), k, g,
                                             v_space, fit)
    assert vars(ginfo) == jax_ginfo(k)
    arrays = interop.graph_to_saved_arrays(g)
    arrays["v_space"] = np.int64(v_space)
    arrays["ginfo_json"] = np.frombuffer(json.dumps(vars(ginfo)).encode(),
                                         np.uint8)
    theirs = tmp_path / "numpy.npz"
    np.savez_compressed(theirs, **arrays)
    ours = tmp_path / "ours" / f"pre_simplify_k{k}.npz"
    assert os.listdir(tmp_path / "ours") == [ours.name]
    with zipfile.ZipFile(ours) as a, zipfile.ZipFile(theirs) as b:
        assert a.namelist() == b.namelist()
        assert a.namelist()[-1] == "ginfo_json.npy"
        assert ([i.compress_type for i in a.infolist()]
                == [i.compress_type for i in b.infolist()])
        for name in b.namelist():
            assert a.read(name) == b.read(name), name
    with np.load(ours) as x, np.load(theirs) as y:
        assert x.files == y.files
        for name in y.files:
            assert x[name].dtype == y[name].dtype, name
            np.testing.assert_array_equal(x[name], y[name])


@pytest.mark.parametrize("phase", [True, False], ids=["save", "no_save"])
def test_a_fit_that_raises_fails_the_rung(reads, tmp_path, monkeypatch,
                                          phase):
    """The worker's exception is raised again where the rung joins the
    fit; the save leaves no file behind."""
    class FitFailed(RuntimeError):
        pass

    def fail(bc):
        raise FitFailed("no fit")

    monkeypatch.setattr(coverage_model, "fit_coverage_model_hist", fail)
    codes, lengths = reads
    phase_dir = tmp_path / "phases"
    with pytest.raises(FitFailed):
        assemble.assemble_single_k(
            codes, lengths, KS[0], device="cpu",
            phase_dir=str(phase_dir) if phase else None)
    assert not phase_dir.exists() or os.listdir(phase_dir) == []


def test_auto_cutoff_reads_the_fit_before_the_filter(reads, jax_ginfo):
    """``min_kmer_count="auto"`` joins the fit before the filter: the
    table is the one filtered with the bound of the JAX package's fit."""
    codes, lengths = reads
    k = KS[0]
    t = torch.from_numpy
    g, v_space, ginfo = assemble._construct(t(codes), t(lengths), k, "auto",
                                            None, True, CPU)
    assert vars(ginfo) == jax_ginfo(k)
    cutoff = max(2, int(ginfo.ec_bound))
    g2, v_space2, _ = assemble._construct(t(codes), t(lengths), k, cutoff,
                                          None, True, CPU)
    assert v_space == v_space2
    ours, fixed = (interop.graph_to_saved_arrays(x) for x in (g, g2))
    assert ours.keys() == fixed.keys()
    for name in ours:
        np.testing.assert_array_equal(ours[name], fixed[name])
