"""Concrete stage list for the main assembly pipeline.

PyTorch counterpart of the JAX package's ``pipeline/spades_stages.py``
(``assemble_genome``'s stage assembly, projects/spades/pipeline.cpp:213-290):
ReadConversion -> [ErrorCorrection] -> one iteration stage per K
(Construction + GenomicInfoFiller + Simplification fused) ->
[GapClosing] -> RepeatResolution -> ContigOutput.

Every stage of the JAX package's list is here: read conversion, error
correction (BayesHammer, or IonHammer with --iontorrent), the iteration
stages or, with --assembly-graph, loading the graph from a GFA file,
rna's strand split (--ss), gap closing, the two hybrid long-read stages
(--pacbio, --nanopore, --sanger), mismatch correction (--careful),
plasmidSPAdes' chromosome removal (--plasmid, --metaplasmid,
--metaviral), the series analysis (--series-analysis), repeat resolution
(paired libraries through exSPAnder path extension and scaffolding, long
reads guiding the extension; without a paired library the contigs pass
through), the domain extraction of the HMM modes (--bio, --corona with
--custom-hmms), meta's second phase and second repeat resolution, contig
output with the circular and linear candidates, and the domain graph.
The long reads are not kept in the context: each stage that needs them
reads the files of the command line again, so a run resumes from any
save (the JAX package keeps them in ``ctx.params``, which its saves
cannot write: ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..graph.from_gfa import graph_from_gfa
from ..graph.graph import edge_mask
from ..hammer import correct as hammer_correct
from ..hammer import ionhammer
from ..io import fasta, fastg, fastq, gfa, hmmfile
from ..mapping import long_read
from ..models import bio, plasmid, rna
from ..mts import abundance
from ..ops import dna
from ..utils import timetrace
from ..utils.device import resolve_device
from ..utils.timetrace import device_scope
from . import assemble, gap_closer, mismatch_correction
from .config import AssemblyConfig
from .stages import PipelineContext, Stage


def _rc_batch(b):
    """Reverse-complement a read batch in place (mirroring qualities)."""
    b.codes = dna.revcomp_reads(torch.from_numpy(b.codes),
                                torch.from_numpy(b.lengths)).numpy()
    if b.quals is not None:
        # mirror each row's quality prefix alongside the RC
        L = b.quals.shape[1]
        idx = (b.lengths.astype(np.int64)[:, None] - 1
               - np.arange(L)[None, :])
        b.quals = np.where(
            idx >= 0,
            np.take_along_axis(b.quals, np.maximum(idx, 0), axis=1),
            0).astype(b.quals.dtype)


def _to_fr(b1, b2, orientation: str):
    """Convert a paired library to FR geometry
    (library.hpp orientation FR/RF/FF): RF ("outie") rc's both mates,
    FF rc's the second mate only."""
    if orientation == "rf":
        _rc_batch(b1)
        _rc_batch(b2)
    elif orientation == "ff":
        _rc_batch(b2)


def _parsed(load, *paths):
    """``load(*paths)`` (a batch, or the two of a pair) inside the span
    ``read_parse``, counting its reads and bases and the files' bytes on
    disk."""
    with timetrace.scope("read_parse"):
        out = load(*paths, with_quals=True)
        if timetrace.enabled():
            for b in (out if isinstance(out, tuple) else (out,)):
                timetrace.count("reads", b.num_reads)
                timetrace.count("bases", int(b.lengths.sum()))
            timetrace.count("file_bytes",
                            sum(os.path.getsize(p) for p in paths))
    return out


def make_read_conversion(pe_pairs, interlaced, singles, log, mp_pairs=(),
                         pe_orientation: str = "fr",
                         mp_orientation: str = "rf", device=None):
    """Parse every library on the host, then put the reads on ``device``
    once, for all the stages after: on the card unless ``"cpu"`` is asked
    for (``resolve_device``, which raises where there is no card)."""
    device = resolve_device(device)

    def run(ctx: PipelineContext):
        batches = []
        paired_ranges = []
        row = 0

        def add_pair(b1, b2, kind):
            nonlocal row
            batches.extend([b1, b2])
            paired_ranges.append((row, b1.num_reads,
                                  row + b1.num_reads, b2.num_reads, kind))
            row += b1.num_reads + b2.num_reads

        for p1, p2 in pe_pairs:
            b1, b2 = _parsed(fastq.load_paired_reads, p1, p2)
            _to_fr(b1, b2, pe_orientation)
            add_pair(b1, b2, "pe")
            log(f"loaded paired library {p1} + {p2}: {b1.num_reads} pairs"
                + (f" ({pe_orientation}->fr)"
                   if pe_orientation != "fr" else ""))
        for p1, p2 in mp_pairs:
            # mate pairs default RF ("outie", library_fwd.hpp MatePairs)
            b1, b2 = _parsed(fastq.load_paired_reads, p1, p2)
            _to_fr(b1, b2, mp_orientation)
            add_pair(b1, b2, "mp")
            log(f"loaded mate-pair library {p1} + {p2}: "
                f"{b1.num_reads} pairs ({mp_orientation}->fr)")
        for ip in interlaced:
            b = _parsed(fastq.load_reads, ip)
            # even rows = first mates, odd = second; split into halves
            q = b.quals
            ev = fastq.ReadBatch(b.codes[0::2], b.lengths[0::2], None,
                                 q[0::2] if q is not None else None)
            od = fastq.ReadBatch(b.codes[1::2], b.lengths[1::2], None,
                                 q[1::2] if q is not None else None)
            add_pair(ev, od, "pe")
            log(f"loaded interlaced library {ip}: {b.num_reads // 2} pairs")
        for sp in singles:
            b = _parsed(fastq.load_reads, sp)
            batches.append(b)
            row += b.num_reads
            log(f"loaded single library {sp}: {b.num_reads} reads")
        batch = fastq.concat_batches(batches)
        with device_scope("read_upload", device):
            codes = np.ascontiguousarray(batch.codes)
            lengths = np.ascontiguousarray(batch.lengths)
            ctx.codes = torch.from_numpy(codes).to(device)
            ctx.lengths = torch.from_numpy(lengths).to(device)
            timetrace.count("bytes", codes.nbytes + lengths.nbytes)
        ctx.quals = batch.quals  # None when any library lacks qualities
        ctx.paired_ranges = paired_ranges
        ctx.read_length = int(batch.lengths.max()) if batch.num_reads else 0
        log(f"total reads: {batch.num_reads}, max length {ctx.read_length}")
    return Stage("read_conversion", run)


def make_error_correction(log, k: int = 21, output_dir: str | None = None,
                          write_corrected: bool = False, device=None):
    """BayesHammer stage. ``write_corrected``: write the corrected reads
    to corrected/corrected.fastq.gz like the reference (whose per-K
    processes re-read them); the reads stay on the device for the stages
    after, so the file is written only on request (--only-error-correction
    asks for it). The qualities, host arrays, are uploaded once here.
    ``device`` as ``correct_reads`` takes it: by default the card the
    context's reads are on, else the first card; the CPU only on
    request."""
    def run(ctx: PipelineContext):
        dev = resolve_device(device, ctx.codes)
        quals = ctx.quals
        if quals is not None:
            quals = torch.from_numpy(np.ascontiguousarray(quals)).to(dev)
        corrected, hstats = hammer_correct.correct_reads(
            ctx.codes, ctx.lengths, k=k, quals=quals, device=dev)
        log(f"correction: {hstats}")
        ctx.codes = corrected
        ctx.params["hammer"] = hstats
        if output_dir is not None and write_corrected:
            _write_corrected(ctx, output_dir, log)
    return Stage("error_correction", run)


def make_ion_error_correction(log, output_dir: str | None = None,
                              device=None):
    """IonTorrent homopolymer-space correction (projects/ionhammer,
    selected by --iontorrent in spades.py options_storage.py); it writes
    corrected/corrected.fastq.gz, as in the JAX package."""
    def run(ctx: PipelineContext):
        codes, lengths, stats = ionhammer.correct_reads_ion(
            ctx.codes, ctx.lengths, device=device)
        log(f"ionhammer: {stats}")
        ctx.codes = codes
        ctx.lengths = lengths
        ctx.params["ionhammer"] = stats
        if output_dir is not None:
            _write_corrected(ctx, output_dir, log)
    return Stage("error_correction", run)


def _write_corrected(ctx: PipelineContext, output_dir: str, log) -> None:
    cdir = os.path.join(output_dir, "corrected")
    os.makedirs(cdir, exist_ok=True)
    path = os.path.join(cdir, "corrected.fastq.gz")
    fastq.write_reads_fastq(path, ctx.codes.cpu().numpy(),
                            ctx.lengths.cpu().numpy())
    log(f"wrote {path}")


def make_iteration(k: int, log, min_contig_length=None, simplify_cfg=None,
                   name=None, min_kmer_count=1, output_dir=None,
                   device=None):
    """One rung. ``device`` as ``assemble_single_k`` takes it: by default
    the card the context's reads are on, else the first card; the CPU
    only on request."""
    def run(ctx: PipelineContext):
        cfg = simplify_cfg
        if cfg is not None and ctx.read_length:
            cfg = dataclasses.replace(cfg, read_length=ctx.read_length)
        # of the last rung only the contigs go on: its graph is released
        # before this rung builds its own
        ctx.graph = None
        res = assemble.assemble_single_k(
            ctx.codes, ctx.lengths, k, cfg=cfg,
            min_contig_length=min_contig_length,
            min_kmer_count=min_kmer_count,
            extra_sequences=[s for s, _ in ctx.contigs],
            phase_dir=(os.path.join(output_dir, "saves", "phases")
                       if output_dir else None),
            device=device)
        ctx.contigs = res.contigs
        ctx.graph = res.graph
        ctx.genomic_info = res.genomic_info
        ctx.params.setdefault("ks_done", []).append(k)
        log(f"K={k}: {res.stats}")
    return Stage(name or f"k{k}", run)


def _range_kind(r) -> str:
    return r[4] if len(r) > 4 else "pe"


def _paired_mate_arrays(ctx: PipelineContext):
    """All first mates and all second mates of the paired libraries,
    gathered where the reads lie (no copy to the host)."""
    dev = ctx.codes.device
    idx1 = torch.from_numpy(np.concatenate(
        [np.arange(r[0], r[0] + r[1]) for r in ctx.paired_ranges])).to(dev)
    idx2 = torch.from_numpy(np.concatenate(
        [np.arange(r[2], r[2] + r[3]) for r in ctx.paired_ranges])).to(dev)
    return (ctx.codes[idx1], ctx.lengths[idx1],
            ctx.codes[idx2], ctx.lengths[idx2])


def _paired_lib_arrays(ctx: PipelineContext):
    """Per-library mate arrays: [(c1, l1, c2, l2, kind)], the per-lib
    model (library.hpp SequencingLibrary) replacing pooled mates; views
    of the reads where they lie (contiguous ranges)."""
    c, l = ctx.codes, ctx.lengths
    libs = []
    for r in ctx.paired_ranges:
        s1, n1, s2, n2 = r[0], r[1], r[2], r[3]
        libs.append((c[s1:s1 + n1], l[s1:s1 + n1],
                     c[s2:s2 + n2], l[s2:s2 + n2],
                     _range_kind(r)))
    return libs


def make_chromosome_removal(log, cfg, output_dir=None):
    """ChromosomeRemoval stage (projects/spades/chromosome_removal.cpp).

    plasmid mode runs the iterated isolated pipeline
    (chromosome_remover.cpp RunIsolatedPipeline); metaplasmid/metaviral
    runs the rising-coverage-cutoff loop (pipeline.cpp:85-97) and writes
    each cutoff's suspicious components (components_NNNN.fasta). The
    graph stays where it lies; the masks are built on the host."""
    def run(ctx: PipelineContext):
        if ctx.graph is None:
            return
        params = plasmid.PlasmidParams(
            long_edge_length=cfg.plasmid_min_edge_length,
            relative_coverage=cfg.plasmid_coverage_uniformity)
        with device_scope("chromosome_removal", ctx.graph.device):
            if cfg.mode in ("metaplasmid", "metaviral"):
                ctx.graph, ctx.contigs = _metaplasmid_candidates(
                    ctx.graph, params, output_dir, log)
            else:
                g = plasmid.run_isolated_pipeline(ctx.graph, params, log=log)
                ctx.graph = g
                ctx.contigs = fasta.graph_contigs(g, min_length=2 * g.k)
        log(f"chromosome removal: {len(ctx.contigs)} candidate edges left")
    return Stage("chromosome_removal", run)


def _metaplasmid_candidates(g, params, output_dir, log):
    """The rising-cutoff loop: (the last graph with an alive edge, the
    union of every cutoff's candidates)."""
    rounds = plasmid.metaplasmid_iterate(g, params, log=log)
    for cov, _, susp in rounds:
        if susp and output_dir:
            plasmid.write_component_fasta(
                os.path.join(output_dir, f"components_{cov:04d}.fasta"),
                cov, susp)
    # the reference emits plasmid contigs per cutoff (ContigOutput after
    # each ChromosomeRemoval round, pipeline.cpp:85-97), so the final set
    # is the UNION of per-cutoff candidates, low-coverage plasmids
    # eliminated at later cutoffs included, deduplicated by canonical
    # sequence
    g = next((rg for _, rg, _ in reversed(rounds)
              if bool(edge_mask(rg).any())), rounds[-1][1] if rounds else g)
    seen = set()
    union: list[tuple[str, float]] = []

    def add(s, cov):
        key = min(s, dna.revcomp_str(s))
        if key not in seen:
            seen.add(key)
            union.append((s, cov))
    for s, cov in fasta.graph_contigs(g, min_length=2 * g.k):
        add(s, cov)
    for _cut, _, susp in rounds:
        for records in susp:
            for _eid, s, ln, cov in records:
                if ln >= 2 * g.k:
                    add(s, cov)
    return g, union


def make_ss_edge_split(ss_orientation: str, log, device=None):
    """SSEdgeSplit stage (common/stages/ss_edge_split.cpp:17-59): split
    edges where the transcribed strand flips (strand-specific RNA). The
    reads are mapped on ``device``: by default the card the context's
    reads are on, else the first card; the CPU only on request."""
    def run(ctx: PipelineContext):
        if ctx.graph is None:
            return
        dev = resolve_device(device, ctx.codes)
        with device_scope("ss_edge_split", dev):
            g, n, _ = rna.split_edges_by_strand(
                ctx.graph, ctx.codes, ctx.lengths,
                ss_orientation=ss_orientation, device=dev)
        ctx.graph = g
        if n:
            ctx.contigs = fasta.graph_contigs(g, min_length=2 * g.k)
        log(f"ss edge split ({ss_orientation}): split {n} edges")
    return Stage("ss_edge_split", run)


def make_second_phase(ks, log, device=None):
    """SecondPhaseSetup (projects/spades/second_phase_setup.cpp): the
    preliminary RR contigs are fed into one more assembly at the last K,
    then repeat resolution runs again. As in the JAX package, this
    assembly takes the isolate SimplifyConfig and the default
    min_kmer_count, whatever the mode's (ROADMAP.md, Queue 3); the
    restricted sequences are those an extract_domains stage left."""
    def run(ctx: PipelineContext):
        if ctx.graph is None or not ctx.final_contigs:
            return
        dev = resolve_device(device, ctx.codes)
        with device_scope("second_phase", dev):
            ctx.graph = None  # released before the new one is built
            res = assemble.assemble_single_k(
                ctx.codes, ctx.lengths, ks[-1],
                extra_sequences=[s for s, _ in ctx.final_contigs],
                restricted_sequences=ctx.params.get("restricted_seqs"),
                device=dev)
        ctx.graph = res.graph
        ctx.contigs = res.contigs
        log(f"second phase: {res.stats}")
    return Stage("second_phase_setup", run)


def make_gap_closing(log, device=None):
    """GapClosing (projects/spades/gap_closer.cpp): ``device`` as
    ``close_gaps`` takes it: by default the card the context's reads are
    on, else the first card; the CPU only on request."""
    def run(ctx: PipelineContext):
        if not ctx.paired_ranges or ctx.graph is None:
            log("gap closing skipped (no paired libraries)")
            return
        dev = resolve_device(device, ctx.codes)
        c1, l1, c2, l2 = _paired_mate_arrays(ctx)
        g, joined = gap_closer.close_gaps(ctx.graph, c1, l1, c2, l2,
                                          device=dev)
        ctx.graph = g
        if joined:
            ctx.contigs = fasta.graph_contigs(g, min_length=2 * g.k)
        log(f"closed {joined} gaps")
    return Stage("gap_closing", run)


def make_load_graph(gfa_path: str, log, device=None):
    """LoadGraph (load_graph.cpp:16-36): the graph of a GFA file takes
    the place of construction, on the run's device (``device``: the card
    unless ``"cpu"`` is asked for)."""
    def run(ctx: PipelineContext):
        ctx.graph = graph_from_gfa(gfa_path, device=device)
        ctx.contigs = fasta.graph_contigs(ctx.graph,
                                          min_length=2 * ctx.graph.k)
        log(f"loaded graph from {gfa_path}: "
            f"{len(ctx.contigs)} segments, k={ctx.graph.k}")
    return Stage("load_graph", run)


def make_mismatch_correction(log, device=None):
    """MismatchCorrection (--careful, mismatch_correction.cpp): every
    read votes on the graph's bases and a strict majority rewrites them.
    ``device`` as ``correct_mismatches`` takes it: by default the card
    the context's reads are on, else the first card; the CPU only on
    request."""
    def run(ctx: PipelineContext):
        if ctx.graph is None:
            return
        g, n = mismatch_correction.correct_mismatches(
            ctx.graph, ctx.codes, ctx.lengths,
            device=resolve_device(device, ctx.codes))
        ctx.graph = g
        if n:
            ctx.contigs = fasta.graph_contigs(g, min_length=2 * g.k)
        log(f"corrected {n} mismatching bases")
    return Stage("mismatch_correction", run)


def _long_read_batch(files):
    """The long reads of the command line's files as one batch."""
    return fastq.concat_batches([fastq.load_reads(p) for p in files])


def make_hybrid_aligning(long_read_files, log, name="hybrid_aligning",
                         device=None):
    """HybridLibrariesAligning (projects/spades/hybrid_aligning.cpp):
    dead-end edge pairs bridged by long reads are joined
    (``long_read.hybrid_close_gaps``). ``device``: by default the card
    the context's reads are on, else the first card; the CPU only on
    request."""
    def run(ctx: PipelineContext):
        if ctx.graph is None:
            return
        b = _long_read_batch(long_read_files)
        dev = resolve_device(device, ctx.codes)
        with device_scope(name, dev):
            g, joined = long_read.hybrid_close_gaps(
                ctx.graph, b.codes, b.lengths, device=dev)
        ctx.graph = g
        if joined:
            ctx.contigs = fasta.graph_contigs(g, min_length=2 * g.k)
        log(f"hybrid gap closing: {joined} joins from "
            f"{b.num_reads} long reads")
    return Stage(name, run)


def _contig_seqs(ctx: PipelineContext) -> list[str]:
    return [s for s, _ in (ctx.final_contigs or ctx.contigs)]


def make_extract_domains(hmm_set: str, output_dir: str, log, device=None):
    """ExtractDomains (projects/spades/extract_domains.cpp): match the
    HMM set against the preliminary contigs, write
    temp_anti/restricted_edges.fasta and keep the hit sequences for the
    second phase's restricted-edge protection."""
    def run(ctx: PipelineContext):
        contig_seqs = _contig_seqs(ctx)
        profiles = hmmfile.load_hmm_set(hmm_set)
        dev = resolve_device(device, ctx.codes)
        with device_scope("extract_domains", dev):
            hits = bio.extract_domains(contig_seqs, profiles,
                                       output_dir=output_dir, device=dev)
        ctx.params["restricted_seqs"] = [h.seq for h in hits]
        log(f"extracted {len(hits)} domain hits from "
            f"{len(profiles)} models over {len(contig_seqs)} contigs")
    return Stage("extract_domains", run)


def make_domain_graph_construction(hmm_set: str, output_dir: str, log,
                                   device=None):
    """DomainGraphConstruction
    (projects/spades/domain_graph_construction.cpp): re-match the final
    contigs, build the domain graph and write the BGC candidates
    (gene_clusters.fasta, bgc_statistics.txt, domain_graph.dot)."""
    def run(ctx: PipelineContext):
        contig_seqs = _contig_seqs(ctx)
        profiles = hmmfile.load_hmm_set(hmm_set)
        dev = resolve_device(device, ctx.codes)
        with device_scope("domain_graph", dev):
            hits = bio.extract_domains(contig_seqs, profiles, device=dev)
        arcs = bio.build_domain_graph(hits)
        chains = bio.bgc_candidates(hits, arcs)
        n = bio.write_bgc_outputs(output_dir, contig_seqs, hits, chains)
        log(f"domain graph: {len(hits)} hits, {len(arcs)} arcs, "
            f"{n} BGC candidates")
    return Stage("domain_graph_construction", run)


def _parse_series_cfg(path: str) -> dict:
    """The flat ``key: value`` lines of the series analysis' YAML file."""
    cfg = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if ":" in line:
                key, val = line.split(":", 1)
                cfg[key.strip()] = val.strip().strip('"')
    return cfg


def make_series_analysis(yaml_path: str, log, device=None):
    """SeriesAnalysis (projects/spades/series_analysis.cpp): load a
    multi-sample k-mer multiplicity table, profile the graph's edges and
    their fragments, and write edges_sqn / edges_mpl /
    edge_fragments_mpl for the mts binner. Every edge's fragments are
    profiled in one search of the table."""
    def run(ctx: PipelineContext):
        if ctx.graph is None:
            return
        cfg = _parse_series_cfg(yaml_path)
        kmers, mult, k = abundance.load_profiles(cfg["kmer_mult"])
        min_len = int(cfg.get("min_len", 0))
        frag_size = int(cfg.get("frag_size", 200))
        seqs = []
        names = []
        for i, (s, cov) in enumerate(
                fasta.graph_contigs(ctx.graph, min_length=min_len)):
            seqs.append(s)
            names.append(f"EDGE_{i + 1}_length_{len(s)}_cov_{cov:.6f}")
        dev = resolve_device(device, ctx.codes)
        frags = [abundance.fragments(s, k, frag_size) for s in seqs]
        with device_scope("series_analysis", dev):
            prof = abundance.contig_abundance(seqs, kmers, mult, k,
                                              device=dev)
            frag_prof = abundance.contig_abundance(
                [f for fs in frags for f in fs], kmers, mult, k,
                device=dev)
        with open(cfg["edges_sqn"], "w") as f:
            for n, s in zip(names, seqs):
                f.write(f">{n}\n{s}\n")
        with open(cfg["edges_mpl"], "w") as f:
            for n, row in zip(names, prof):
                f.write(n + "\t" + "\t".join(f"{v:.2f}" for v in row)
                        + "\n")
        with open(cfg["edge_fragments_mpl"], "w") as f:
            at = 0
            for n, fs in zip(names, frags):
                for j, row in enumerate(frag_prof[at:at + len(fs)]):
                    f.write(f"{n}_f{j}\t" + "\t".join(
                        f"{v:.2f}" for v in row) + "\n")
                at += len(fs)
        log(f"series analysis: profiled {len(seqs)} edges over "
            f"{mult.shape[1]} samples")
    return Stage("series_analysis", run)


def make_repeat_resolution(log, output_dir=None, device=None,
                           long_read_files=()):
    """RepeatResolution (projects/spades/repeat_resolving.cpp): without
    a paired library the contigs pass through; with one,
    ``assemble.repeat_resolution_multi`` over each library (and the long
    reads of ``long_read_files``, read again here), and the paths,
    scaffold graph and library data it reports are written."""
    def run(ctx: PipelineContext):
        if not ctx.paired_ranges or ctx.graph is None:
            ctx.final_contigs = list(ctx.contigs)
            log("no paired libraries: RR skipped (contig paths only, "
                "repeat_resolving.cpp:62 'rr disabled' branch)")
            return
        dev = resolve_device(device, ctx.codes)
        libs = _paired_lib_arrays(ctx)
        lib_data: list = []
        sg_out: dict = {}
        paths_out: dict = {}
        long_reads = None
        if long_read_files:
            b = _long_read_batch(long_read_files)
            long_reads = (b.codes, b.lengths)
        final, scaffolds = assemble.repeat_resolution_multi(
            ctx.graph, libs, with_scaffolds=True, lib_data_out=lib_data,
            scaffold_graph_out=sg_out, long_reads=long_reads,
            paths_out=paths_out, device=dev)
        # edge-id paths feed contigs.paths/scaffolds.paths + GFA P
        # records at contig output (contig_output_stage.cpp:105-112)
        ctx.params["contig_paths"] = [
            [[int(e), 0] for e in p] for p in paths_out.get("contigs", [])]
        ctx.params["scaffold_paths"] = [
            [[int(e), int(gap)] for e, gap in p]
            for p in paths_out.get("scaffolds", [])]
        if output_dir is not None and "graph" in sg_out:
            # PrintScaffoldGraph (launcher.cpp:85): .scg dump + dot
            sg = sg_out["graph"]
            with open(os.path.join(output_dir,
                                   "scaffold_graph.scg"), "w") as f:
                f.write(sg.to_tsv())
            with open(os.path.join(output_dir,
                                   "scaffold_graph.dot"), "w") as f:
                f.write(sg.to_dot(ctx.graph))
            log(f"scaffold graph: {sg.vertex_count} vertices, "
                f"{sg.edge_count} connections")
        ctx.final_contigs = final
        ctx.scaffolds = scaffolds
        ctx.params["lib_data"] = lib_data
        for i, ld in enumerate(lib_data):
            log(f"  lib {i} ({ld['kind']}): IS median "
                f"{ld['insert_size_median']:.0f} mad "
                f"{ld['insert_size_mad']:.0f} from {ld['pairs_used']} "
                f"pairs")
        if output_dir is not None:
            # final.lib_data equivalent (pipeline.cpp:288 write_lib_data)
            with open(os.path.join(output_dir, "final.lib_data"),
                      "w") as f:
                for i, ld in enumerate(lib_data):
                    f.write(f"- lib: {i}\n")
                    for key, val in ld.items():
                        f.write(f"  {key}: {val}\n")
        log(f"resolved {len(final)} paths, {len(scaffolds)} scaffolds "
            f"({len(libs)} libs)")
    return Stage("repeat_resolution", run)


def make_contig_output(output_dir: str, log, cfg=None):
    def run(ctx: PipelineContext):
        fasta.write_contigs_fasta(
            os.path.join(output_dir, "before_rr.fasta"), ctx.contigs)
        final = ctx.final_contigs or ctx.contigs
        fasta.write_contigs_fasta(
            os.path.join(output_dir, "contigs.fasta"), final)
        fasta.write_contigs_fasta(
            os.path.join(output_dir, "scaffolds.fasta"),
            ctx.scaffolds or final)
        if cfg is not None and cfg.circular_output and ctx.graph is not None:
            _write_circular(ctx.graph, cfg, output_dir, log)
        if ctx.graph is not None:
            def named(contig_list, raw_paths):
                # names must match the fasta headers the same list got
                return [(f"NODE_{i}_length_{len(s)}_cov_{c:.6f}",
                         [(int(e), int(gap)) for e, gap in p])
                        for i, ((s, c), p) in enumerate(
                            zip(contig_list, raw_paths), start=1)]
            cpaths = named(final, ctx.params.get("contig_paths", []))
            spaths = named(ctx.scaffolds or final,
                           ctx.params.get("scaffold_paths", []))
            # scaffold paths ride the GFA as P records; the .paths files
            # mirror the FastG edge numbering (contig_output_stage.cpp:
            # 105-112 WritePaths on both writers)
            gfa.write_gfa(
                os.path.join(output_dir,
                             "assembly_graph_with_scaffolds.gfa"),
                ctx.graph, paths=spaths)
            if cpaths:
                gfa.write_paths_file(
                    os.path.join(output_dir, "contigs.paths"),
                    ctx.graph, cpaths)
            if spaths:
                gfa.write_paths_file(
                    os.path.join(output_dir, "scaffolds.paths"),
                    ctx.graph, spaths)
            fastg.write_fastg(os.path.join(
                output_dir, "assembly_graph.fastg"), ctx.graph)
        log(f"wrote {len(final)} contigs to {output_dir}")
    return Stage("contig_output", run)


def _write_circular(g, cfg, output_dir: str, log) -> None:
    """contigs.circular.fasta, and for metaviral contigs.linears.fasta
    (contig_output_stage.cpp:213-240)."""
    circ = plasmid.circular_contigs(g)
    plasmid.write_plasmid_fasta(
        os.path.join(output_dir, "contigs.circular.fasta"), circ)
    log(f"circular output: {sum(1 for _, _, c in circ if c)} "
        f"circular of {len(circ)} candidates")
    if cfg.plasmid_output_linear:
        # metaviral (metaviral_mode.info output_linear true): linear
        # dead-end-bounded candidates too (GetTipScaffolds)
        linears = [(s, cv, False) for s, cv, c in circ
                   if not c and len(s) >= cfg.plasmid_min_linear_length]
        plasmid.write_plasmid_fasta(
            os.path.join(output_dir, "contigs.linears.fasta"), linears)
        log(f"linear viral candidates: {len(linears)}")


def build_stage_list(args, ks, log, cfg=None, device=None):
    """pipeline.cpp:250-285 equivalent (mode-aware), in the JAX package's
    order; ``device`` is where the reads and graphs live: the card unless
    ``"cpu"`` is asked for, and without a card this raises."""
    device = resolve_device(device)
    if cfg is None:
        cfg = AssemblyConfig()
    pe_pairs = list(zip(args.pe1, args.pe2))
    mp_pairs = list(zip(getattr(args, "mp1", []), getattr(args, "mp2", [])))
    paired = bool(pe_pairs or mp_pairs or args.interlaced)
    stages = [make_read_conversion(
        pe_pairs, args.interlaced, args.single, log, mp_pairs=mp_pairs,
        pe_orientation=getattr(args, "pe_orientation", "fr"),
        mp_orientation=getattr(args, "mp_orientation", "rf"),
        device=device)]
    if not args.only_assembler and cfg.correction_enabled:
        if getattr(args, "iontorrent", False):
            stages.append(make_ion_error_correction(
                log, output_dir=args.output_dir, device=device))
        else:
            stages.append(make_error_correction(
                log, output_dir=args.output_dir,
                write_corrected=args.only_error_correction, device=device))
    if getattr(args, "assembly_graph", None):
        # LoadGraph replaces construction (load_graph.cpp:16-36)
        stages.append(make_load_graph(args.assembly_graph, log,
                                      device=device))
    else:
        cc = getattr(args, "cov_cutoff", "off")
        min_kc = 1 if cc == "off" else ("auto" if cc == "auto" else int(cc))
        for k in ks:
            stages.append(make_iteration(
                k, log, min_contig_length=args.min_contig_length,
                simplify_cfg=cfg.simplify, min_kmer_count=min_kc,
                output_dir=args.output_dir, device=device))
    if getattr(args, "ss", None) and cfg.strand_specific:
        stages.append(make_ss_edge_split(args.ss, log, device=device))
    if paired:
        stages.append(make_gap_closing(log, device=device))
    long_reads = (getattr(args, "pacbio", []) +
                  getattr(args, "nanopore", []) +
                  getattr(args, "sanger", []))
    if long_reads:
        # the reference runs HybridLibrariesAligning twice
        # (pipeline.cpp:271-274)
        # once before and once after pair-based cleanup, so second-round
        # joins see the improved graph
        stages.append(make_hybrid_aligning(long_reads, log, device=device))
        stages.append(make_hybrid_aligning(long_reads, log,
                                           name="hybrid_aligning_2",
                                           device=device))
    if cfg.careful or getattr(args, "careful", False):
        stages.append(make_mismatch_correction(log, device=device))
    if cfg.chromosome_removal:
        stages.append(make_chromosome_removal(log, cfg,
                                              output_dir=args.output_dir))
    if getattr(args, "series_analysis", None):
        # before RR (pipeline.cpp:205-206)
        stages.append(make_series_analysis(args.series_analysis, log,
                                           device=device))

    def repeat_resolution(name):
        return dataclasses.replace(
            make_repeat_resolution(log, args.output_dir, device=device,
                                   long_read_files=long_reads),
            name=name)

    stages.append(repeat_resolution("repeat_resolution"))
    hmm_set = getattr(args, "custom_hmms", None)
    if cfg.two_step_rr:
        if hmm_set:
            # ExtractDomains on the preliminary contigs
            # (pipeline.cpp:145-146)
            stages.append(make_extract_domains(
                hmm_set, args.output_dir, log, device=device))
        # meta: SecondPhaseSetup re-feeds the preliminary RR contigs into
        # a final iteration + RR, restricted edges protected
        stages.append(make_second_phase(ks, log, device=device))
        stages.append(repeat_resolution("repeat_resolution_2"))
    stages.append(make_contig_output(args.output_dir, log, cfg))
    if hmm_set:
        # DomainGraphConstruction last (pipeline.cpp:285-286)
        stages.append(make_domain_graph_construction(
            hmm_set, args.output_dir, log, device=device))
    return stages
