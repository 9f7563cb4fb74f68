"""Standalone tool CLIs mirroring the reference's auxiliary binaries
(SURVEY.md §2.10): one dispatcher with subcommands instead of separate
executables. PyTorch counterpart of the JAX package's ``tools.py`` (its
``spades-tpu-tools`` script): the same 19 tools, names and arguments,
and the same output files; every tool also takes ``--device`` (the card
by default, ``cpu`` on request). Without a card and without ``--device
cpu`` a tool exits 1 before any work.

    python -m spades_for_blackbird_tpu_torch.tools <tool> ...

Tools:
  gbuilder        graph builder -> GFA/FASTG/unitig FASTA
                  (projects/gbuilder/main.cpp:103-220)
  kmercount       disk k-mer counter -> TSV of (kmer, count)
                  (projects/kmercount/main.cpp:186-215)
  kmer-estimating HLL cardinality estimator
                  (projects/kmercount/kmer_estimating.cpp:61)
  read-filter     drop reads with low median k-mer coverage
                  (projects/kmercount/read_filter.cpp:80-122)
  gsimplifier     simplify a GFA graph in place
                  (projects/gsimplifier, metaMAG usage)
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np
import torch

from .utils.device import resolve_device


class _NoCard(Exception):
    """No card and no ``--device cpu``: the tool stops before any work."""


def _parser(prog: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def _device(a) -> torch.device:
    try:
        return resolve_device(a.device)
    except RuntimeError as e:
        raise _NoCard(str(e)) from e


def _load(paths):
    from .io import fastq
    batches = [fastq.load_reads(p) for p in paths]
    return fastq.concat_batches(batches)


def _out(path: str):
    return sys.stdout if path == "-" else open(path, "w")


def _close(out) -> None:
    if out is not sys.stdout:
        out.close()


def cmd_gbuilder(argv):
    p = _parser("gbuilder")
    p.add_argument("reads", nargs="+")
    p.add_argument("-k", type=int, default=55)
    p.add_argument("--gfa", default=None)
    p.add_argument("--fastg", default=None)
    p.add_argument("--unitigs", default=None)
    p.add_argument("--min-count", type=int, default=1)
    a = p.parse_args(argv)
    dev = _device(a)
    from .graph import construct
    from .io import fasta, fastg, gfa
    b = _load(a.reads)
    g = construct.graph_from_reads(b.codes, b.lengths, a.k,
                                   min_count=a.min_count, device=dev)
    stats = construct.graph_stats(g)
    print(f"graph: {stats}")
    if a.gfa:
        gfa.write_gfa(a.gfa, g)
    if a.fastg:
        fastg.write_fastg(a.fastg, g)
    if a.unitigs:
        fasta.write_contigs_fasta(a.unitigs, fasta.graph_contigs(g))
    return 0


def _text_rows(codes: np.ndarray, lengths: np.ndarray) -> list[bytes]:
    """Each code row's first ``lengths`` bases as ASCII bytes."""
    from .ops import dna
    text = dna.CODE_TO_CHAR[np.minimum(codes, dna.INVALID_CODE)]
    return [row.tobytes()[:n] for row, n in zip(text, lengths.tolist())]


def cmd_kmercount(argv):
    p = _parser("kmercount")
    p.add_argument("reads", nargs="+")
    p.add_argument("-k", type=int, default=21)
    p.add_argument("-o", "--output", default="-")
    p.add_argument("--min-count", type=int, default=1)
    a = p.parse_args(argv)
    dev = _device(a)
    from .kmers import counter
    from .ops import dna
    b = _load(a.reads)
    t = counter.count_kmers(torch.from_numpy(b.codes).to(dev),
                            torch.from_numpy(b.lengths).to(dev), a.k)
    if a.min_count > 1:
        t = counter.filter_min_count(t, a.min_count)
    n = int(t.num)
    out = _out(a.output)
    step = 1 << 18
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        kms = dna.unpack_kmers(t.kmers[lo:hi], a.k).cpu().numpy()
        rows = _text_rows(kms, np.full(hi - lo, a.k))
        cnts = t.counts[lo:hi].cpu().tolist()
        out.write("".join(f"{r.decode()}\t{c}\n"
                          for r, c in zip(rows, cnts)))
    _close(out)
    print(f"{n} distinct canonical {a.k}-mers", file=sys.stderr)
    return 0


def cmd_kmer_estimating(argv):
    p = _parser("kmer-estimating")
    p.add_argument("reads", nargs="+")
    p.add_argument("-k", type=int, default=21)
    a = p.parse_args(argv)
    dev = _device(a)
    from .kmers import hll
    b = _load(a.reads)
    est = hll.estimate_kmer_cardinality(b.codes, b.lengths, a.k, device=dev)
    print(f"{est:.0f}")
    return 0


def cmd_read_filter(argv):
    p = _parser("read-filter")
    p.add_argument("reads", nargs="+")
    p.add_argument("-k", type=int, default=21)
    p.add_argument("--min-coverage", type=int, default=2,
                   help="drop reads whose median k-mer count is below this")
    p.add_argument("-o", "--output", required=True)
    a = p.parse_args(argv)
    dev = _device(a)
    from .kmers import counter
    from .ops import segments
    b = _load(a.reads)
    codes = torch.from_numpy(b.codes).to(dev)
    lengths = torch.from_numpy(b.lengths).to(dev)
    R = codes.shape[0]
    t = counter.count_kmers(codes, lengths, a.k)
    # every valid window's k-mer is in the table counted from these
    # reads, so the windows found are the valid ones
    valid, row, _ = counter.lookup_windows(
        segments.fuse_words(t.kmers), t.num, codes, lengths, a.k)
    cnt = torch.where(valid, t.counts[row], 0)
    # median over valid positions: sort each row and index the middle
    cnt_sorted = torch.sort(torch.where(valid, cnt, 1 << 30), dim=1).values
    nvalid = valid.sum(dim=1)
    med = cnt_sorted[torch.arange(R, device=dev),
                     torch.clamp(nvalid // 2, min=0)]
    keep = ((med >= a.min_coverage) & (nvalid > 0)).cpu().numpy()
    idx = np.nonzero(keep)[0]
    with open(a.output, "wb") as f:
        for lo in range(0, len(idx), 1 << 16):
            part = idx[lo:lo + (1 << 16)]
            rows = _text_rows(b.codes[part], b.lengths[part])
            f.write(b"".join(b">read_%d\n%s\n" % (i, r)
                             for i, r in zip(part.tolist(), rows)))
    print(f"kept {len(idx)}/{R} reads", file=sys.stderr)
    return 0


def cmd_gsimplifier(argv):
    p = _parser("gsimplifier")
    p.add_argument("input_gfa")
    p.add_argument("output_gfa")
    p.add_argument("--read-length", type=int, default=100)
    p.add_argument("--ec-bound", type=float, default=2.0)
    a = p.parse_args(argv)
    dev = _device(a)
    from .graph import construct
    from .graph.from_gfa import graph_from_gfa
    from .io import gfa
    from .simplify import runner
    g = graph_from_gfa(a.input_gfa, device=dev)
    v_space = int(g.start_v.max()) + 2 if g.capacity else 2
    v_space = max(v_space, int(g.end_v.max()) + 2)
    cfg = runner.SimplifyConfig(read_length=a.read_length)
    g = runner.simplify_graph(g, v_space, a.ec_bound, cfg)
    gfa.write_gfa(a.output_gfa, g)
    print(f"simplified: {construct.graph_stats(g)}", file=sys.stderr)
    return 0


def _cigar_dp(a: str, b: str) -> str:
    """CIGAR of aligning b onto a: global edit DP + run-length traceback
    (spaligner computes this with edlib, mapping_printer.cpp:99-121
    FormCigar; M covers match and mismatch as in edlib path output)."""
    n, m = len(a), len(b)
    if n == 0:
        return f"{m}I" if m else ""
    if m == 0:
        return f"{n}D"
    D = np.zeros((n + 1, m + 1), np.int32)
    D[:, 0] = np.arange(n + 1)
    D[0, :] = np.arange(m + 1)
    bb = np.frombuffer(b.encode(), np.uint8)
    for i in range(1, n + 1):
        sub = D[i - 1, :m] + (bb != ord(a[i - 1]))
        dele = D[i - 1, 1:] + 1
        # the row's running min over insertions is a scan
        row = D[i]
        prev = row[0]
        for j in range(1, m + 1):
            prev = min(sub[j - 1], dele[j - 1], prev + 1)
            row[j] = prev
    # traceback
    ops = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and D[i, j] == D[i - 1, j - 1] + (
                a[i - 1] != b[j - 1]):
            ops.append("M")
            i, j = i - 1, j - 1
        elif i > 0 and D[i, j] == D[i - 1, j] + 1:
            ops.append("D")
            i -= 1
        else:
            ops.append("I")
            j -= 1
    ops.reverse()
    out = []
    run, ch = 0, ""
    for o in ops:
        if o == ch:
            run += 1
        else:
            if run:
                out.append(f"{run}{ch}")
            run, ch = 1, o
    if run:
        out.append(f"{run}{ch}")
    return "".join(out)


def cmd_gmapper(argv):
    """Long-read-to-graph aligner (projects/gmapper + spaligner's batch
    alignment, align_longreads.cpp): reads + GFA -> edge-path output in
    spaligner's formats (tsv/gpa/fasta, MappingPrinterHub,
    mapping_printer.hpp:115-130)."""
    p = _parser("gmapper")
    p.add_argument("graph_gfa")
    p.add_argument("reads", nargs="+")
    p.add_argument("-o", "--output", default="-",
                   help="TSV output path ('-' = stdout)")
    p.add_argument("--output-dir", default=None,
                   help="spaligner-style output dir: writes "
                        "alignment.<fmt> for each --output-format")
    p.add_argument("--output-format", default="tsv",
                   help="comma list of tsv,gpa,fasta "
                        "(align_longreads.cpp output_format)")
    p.add_argument("--seed-k", type=int, default=13)
    a = p.parse_args(argv)
    dev = _device(a)
    from .graph.from_gfa import graph_from_gfa
    from .graph.host import host_view
    from .mapping import long_read
    from .ops import dna as dna_ops
    g = graph_from_gfa(a.graph_gfa, device=dev)
    b = _load(a.reads)
    als = long_read.align_long_reads(g, b.codes, b.lengths,
                                     seed_k=a.seed_k, device=dev)
    formats = {f.strip() for f in a.output_format.split(",") if f.strip()}

    hv = host_view(g)
    flat, starts, elens = hv.seq_flat, hv.seq_start, hv.seq_len
    codes_np, lens_np = b.codes, b.lengths

    def edge_seq(e, lo=None, hi=None):
        lo = 0 if lo is None else lo
        hi = int(elens[e]) if hi is None else hi
        return dna_ops.decode_codes(
            flat[starts[e] + lo:starts[e] + hi])

    def read_seq(r, lo=None, hi=None):
        lo = 0 if lo is None else lo
        hi = int(lens_np[r]) if hi is None else hi
        return dna_ops.decode_codes(codes_np[r, lo:hi])

    def tsv_lines(out):
        # MappingPrinterTSV::SaveMapping (mapping_printer.cpp:22-61)
        out.write("#read\tseq_starts\tseq_ends\tedge_starts\tedge_ends"
                  "\tread_len\tedge_path\tpath_lens\tpath_seq\n")
        for r, al in enumerate(als):
            if not al.chain:
                continue
            blocks = [edge_seq(h.edge, h.edge_lo, h.edge_hi)
                      for h in al.chain]
            out.write("{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}\n".format(
                al.read_id,
                al.chain[0].read_lo, al.chain[-1].read_hi,
                al.chain[0].edge_lo, al.chain[-1].edge_hi,
                int(lens_np[r]),
                ",".join(str(h.edge) for h in al.chain),
                ",".join(str(len(s)) for s in blocks),
                ",".join(blocks)))

    def fasta_lines(out):
        # MappingPrinterFasta::SaveMapping (mapping_printer.cpp:63-87)
        for al in als:
            if not al.chain:
                continue
            seq = "".join(edge_seq(h.edge, h.edge_lo, h.edge_hi)
                          for h in al.chain)
            out.write(">{}|Edges={}|start_g={}|end_g={}|start_s={}"
                      "|end_s={}\n{}\n".format(
                          al.read_id,
                          "_".join(str(h.edge) for h in al.chain),
                          al.chain[0].edge_lo, al.chain[-1].edge_hi,
                          al.chain[0].read_lo, al.chain[-1].read_hi,
                          seq))

    def gpa_lines(out):
        # MappingPrinterGPA: 'H' header + one 13-field 'A' record per
        # traversed edge, linked prev/next (mapping_printer.cpp:195-229)
        out.write("H\n")
        cols = ["Ind", "Name", "ReadName", "StartR", "LenR", "DirR",
                "EdgeId", "StartE", "LenE", "DirE", "CIGAR", "Prev",
                "Next"]
        for r, al in enumerate(als):
            if not al.chain:
                continue
            idx = 0
            prev = "-"
            for i, h in enumerate(al.chain):
                nxt = ("-" if i + 1 == len(al.chain)
                       else f"{al.read_id}_{idx + 1}")
                sub = read_seq(r, h.read_lo, h.read_hi)
                eseq = edge_seq(h.edge, h.edge_lo, h.edge_hi)
                line = {
                    "Ind": "A",
                    "Name": f"{al.read_id}_{idx}",
                    "ReadName": str(al.read_id),
                    "StartR": str(h.read_lo),
                    "LenR": str(h.read_hi - h.read_lo),
                    "DirR": "+",
                    "EdgeId": str(h.edge),
                    "StartE": str(h.edge_lo),
                    "LenE": str(h.edge_hi - h.edge_lo),
                    "DirE": "+",
                    "CIGAR": _cigar_dp(sub, eseq),
                    "Prev": prev,
                    "Next": nxt,
                }
                prev = f"{al.read_id}_{idx}"
                idx += 1
                out.write("\t".join(line[c] for c in cols) + "\t\n")

    writers = {"tsv": tsv_lines, "gpa": gpa_lines, "fasta": fasta_lines}
    unknown = formats - set(writers)
    if unknown:
        print(f"unknown output format(s): {sorted(unknown)}",
              file=sys.stderr)
        return 2
    if a.output_dir:
        os.makedirs(a.output_dir, exist_ok=True)
        for fmt in sorted(formats):
            with open(os.path.join(a.output_dir,
                                   f"alignment.{fmt}"), "w") as f:
                writers[fmt](f)
    else:
        out = _out(a.output)
        tsv_lines(out)
        _close(out)
    print(f"aligned {sum(1 for al in als if al.chain)}/{len(als)} reads",
          file=sys.stderr)
    return 0


def _read_fasta(path):
    names, seqs, cur = [], [], []
    for line in open(path):
        if line.startswith(">"):
            if cur:
                seqs.append("".join(cur))
            names.append(line[1:].split()[0])
            cur = []
        else:
            cur.append(line.strip())
    if cur:
        seqs.append("".join(cur))
    return names, seqs


def cmd_kmer_multiplicity_counter(argv):
    """Multi-sample k-mer multiplicity profiles
    (projects/mts/kmer_multiplicity_counter.cpp)."""
    p = _parser("kmer-multiplicity-counter")
    p.add_argument("samples", nargs="+",
                   help="one reads file per sample")
    p.add_argument("-k", type=int, default=21)
    p.add_argument("-o", "--output", required=True,
                   help="output .npz profile table")
    p.add_argument("--min-mult", type=int, default=2)
    a = p.parse_args(argv)
    dev = _device(a)
    from .mts import abundance
    batches = []
    for s in a.samples:
        b = _load([s])
        batches.append((b.codes, b.lengths))
    kmers, mult = abundance.multiplicity_profiles(batches, a.k,
                                                  min_mult=a.min_mult,
                                                  device=dev)
    abundance.save_profiles(a.output, kmers, mult, a.k)
    print(f"{len(kmers)} k-mers x {mult.shape[1]} samples -> {a.output}",
          file=sys.stderr)
    return 0


def cmd_contig_abundance(argv):
    """Per-contig abundance profiles
    (projects/mts/contig_abundance_counter.cpp)."""
    p = _parser("contig-abundance")
    p.add_argument("contigs", help="FASTA")
    p.add_argument("profiles", help=".npz from kmer-multiplicity-counter")
    p.add_argument("-o", "--output", default="-")
    p.add_argument("--stat", choices=["median", "mean"], default="median")
    a = p.parse_args(argv)
    dev = _device(a)
    from .mts import abundance
    names, seqs = _read_fasta(a.contigs)
    kmers, mult, k = abundance.load_profiles(a.profiles)
    prof = abundance.contig_abundance(seqs, kmers, mult, k, stat=a.stat,
                                      device=dev)
    out = _out(a.output)
    for n, row in zip(names, prof):
        out.write(n + "\t" + "\t".join(f"{v:.2f}" for v in row) + "\n")
    _close(out)
    return 0


def cmd_prop_binning(argv):
    """Propagate bin annotation over a GFA graph + bin reads
    (projects/mts/prop_binning.cpp)."""
    p = _parser("prop-binning")
    p.add_argument("graph_gfa")
    p.add_argument("annotation", help="'segment<TAB>bin' lines")
    p.add_argument("-o", "--output", required=True,
                   help="output propagated annotation")
    p.add_argument("--reads", nargs="*", default=[],
                   help="optionally bin these reads per label")
    p.add_argument("--reads-out-prefix", default="binned")
    a = p.parse_args(argv)
    dev = _device(a)
    from .graph.from_gfa import graph_from_gfa
    from .graph.host import host_view
    from .mts import binning
    g, seg_names = graph_from_gfa(a.graph_gfa, return_names=True,
                                  device=dev)
    hv = host_view(g)
    ann = binning.read_annotation(a.annotation)
    edge_bins = {e: ann[name] for e, name in seg_names.items()
                 if name in ann}
    labels = binning.propagate_bins(hv, edge_bins)
    name_of = {e: n for e, n in seg_names.items()}
    binning.write_annotation(a.output, {
        name_of[e]: b for e, b in labels.items() if e in name_of})
    stats = binning.binning_stats(hv, labels)
    for b, s in sorted(stats.items()):
        print(f"bin {b}: {s['edges']} edges, {s['length']} bp, "
              f"cov {s['mean_cov']:.1f}", file=sys.stderr)
    if a.reads:
        b = _load(a.reads)
        per_bin = binning.bin_reads(g, labels, b.codes, b.lengths,
                                    device=dev)
        from .io import fastq
        for lbl, idxs in per_bin.items():
            path = f"{a.reads_out_prefix}.{lbl}.fastq.gz"
            fastq.write_reads_fastq(path, b.codes[idxs], b.lengths[idxs])
            print(f"bin {lbl}: {len(idxs)} reads -> {path}",
                  file=sys.stderr)
    return 0


def cmd_vis(argv):
    """Interactive graph inspector REPL (projects/online_vis)."""
    from . import vis
    _device(_parser("vis").parse_known_args(argv)[0])
    return vis.main(argv)


def cmd_scf_correction(argv):
    """truSPAdes scaffold correction
    (projects/scaffold_correction/scaffold_correction.hpp:186-233):
    re-thread scaffolds through the graph, filling N-gaps with real
    graph paths when a valid connection exists."""
    p = _parser("scf-correction")
    p.add_argument("graph_gfa")
    p.add_argument("scaffolds", help="FASTA (may contain N gaps)")
    p.add_argument("-o", "--output", required=True)
    a = p.parse_args(argv)
    dev = _device(a)
    from .graph.from_gfa import graph_from_gfa
    from .path_extend import scf_correction
    g = graph_from_gfa(a.graph_gfa, device=dev)
    names, seqs = _read_fasta(a.scaffolds)
    fixed, n = scf_correction.correct_scaffolds(
        g, list(zip(names, seqs)), device=dev)
    with open(a.output, "w") as f:
        for name, s in fixed:
            f.write(f">{name}\n{s}\n")
    print(f"corrected {n}/{len(fixed)} scaffolds", file=sys.stderr)
    return 0


def cmd_unitig_coverage(argv):
    """Per-unitig read coverage profiles over a GFA
    (projects/unitig_coverage/main.cpp + profile_storage.cpp)."""
    p = _parser("unitig-coverage")
    p.add_argument("graph_gfa")
    p.add_argument("reads", nargs="+")
    p.add_argument("-o", "--output", default="-")
    a = p.parse_args(argv)
    dev = _device(a)
    from .graph.from_gfa import graph_from_gfa
    from .mapping import chunked
    from .mapping import index as eidx
    from .mapping import mapper
    g, names = graph_from_gfa(a.graph_gfa, return_names=True, device=dev)
    b = _load(a.reads)
    idx = eidx.build_edge_index(g, g.k + 1, device=dev)
    codes = torch.from_numpy(b.codes).to(dev)
    lengths = torch.from_numpy(b.lengths).to(dev)
    counts = torch.zeros(g.capacity, dtype=torch.int64, device=dev)
    chunk = chunked.map_chunk_reads(codes.shape[1], g.k + 1, dev)
    for lo in range(0, codes.shape[0], chunk):
        m = mapper.normalize_mapping(mapper.map_reads(
            idx, g.seq_len, codes[lo:lo + chunk], lengths[lo:lo + chunk],
            g.k + 1), g.conj)
        counts.index_add_(0, m.oriented_edge[m.mapped] // 2,
                          torch.ones_like(m.oriented_edge[m.mapped]))
    counts = counts.cpu().numpy()
    conj = g.conj.cpu().numpy()
    lens = g.seq_len.cpu().numpy()
    rl = float(b.lengths.mean()) if b.num_reads else 0.0
    out = _out(a.output)
    for e, name in sorted(names.items()):
        n_reads = int(counts[e] + counts[conj[e]])
        depth = n_reads * rl / max(int(lens[e]), 1)
        out.write(f"{name}\t{n_reads}\t{depth:.2f}\n")
    _close(out)
    return 0


def cmd_edge_positions(argv):
    """Edge positions in named reference sequences: the
    EdgePositionHandler dump (handlers/edges_position_handler.hpp:22,
    developer-mode detail printers)."""
    p = _parser("edge-positions")
    p.add_argument("graph_gfa")
    p.add_argument("reference", help="FASTA of named sequences")
    p.add_argument("-o", "--output", default="-")
    a = p.parse_args(argv)
    dev = _device(a)
    from .graph import positions as pos_mod
    from .graph.from_gfa import graph_from_gfa
    g, names = graph_from_gfa(a.graph_gfa, return_names=True, device=dev)
    rnames, rseqs = _read_fasta(a.reference)
    seqs = dict(zip(rnames, rseqs))
    lines = pos_mod.positions_table(g, seqs, device=dev)
    rename = {e: n for e, n in names.items()}
    out = _out(a.output)
    for line in lines:
        e, rest = line.split("\t", 1)
        out.write(f"{rename.get(int(e), e)}\t{rest}\n")
    _close(out)
    return 0


def cmd_cds_subgraphs(argv):
    """CDS subgraph extraction by profile HMM
    (projects/cds_subgraphs/subgraph_extraction.cpp): find domain hits on
    the graph's unitigs and emit the hit CDS FASTA plus the local
    subgraph around each hit as GFA."""
    p = _parser("cds-subgraphs")
    p.add_argument("graph_gfa")
    p.add_argument("--hmms", required=True)
    p.add_argument("-o", "--out-prefix", required=True)
    p.add_argument("--radius", type=int, default=2,
                   help="neighbourhood depth around hit edges")
    p.add_argument("--threshold", type=float, default=20.0)
    a = p.parse_args(argv)
    dev = _device(a)
    from .graph.from_gfa import graph_from_gfa
    from .graph.graph import edge_codes_host
    from .graph.host import edge_mask, host_view
    from .io import gfa as gfa_io
    from .io import hmmfile
    from .models import bio
    from .ops import dna
    from .vis import VisSession
    g = graph_from_gfa(a.graph_gfa, device=dev)
    hv = host_view(g)
    alive = np.nonzero(edge_mask(hv))[0]
    unitigs = [dna.decode_codes(edge_codes_host(hv, int(e)))
               for e in alive]
    profiles = hmmfile.load_hmm_set(a.hmms)
    hits = bio.extract_domains(unitigs, profiles,
                               score_threshold=a.threshold, device=dev)
    with open(a.out_prefix + ".cds.fasta", "w") as f:
        for i, h in enumerate(hits):
            f.write(f">{h.name}_{i}_edge_{int(alive[h.contig])}"
                    f"_{h.nt_start}_{h.nt_end}\n{h.seq}\n")
    sess = VisSession(device=dev)
    sess.g = g
    sel = set()
    for h in hits:
        sel |= sess._neighborhood(int(alive[h.contig]), a.radius)
    keep = np.zeros(g.capacity, bool)
    if sel:
        sel_l = list(sel)
        keep[sel_l] = True
        keep[hv.conj[sel_l]] = True
    sub = g._replace(alive=g.alive & torch.from_numpy(keep).to(dev))
    gfa_io.write_gfa(a.out_prefix + ".subgraph.gfa", sub)
    print(f"{len(hits)} CDS hits, subgraph of {int(keep.sum())} edges",
          file=sys.stderr)
    return 0


def cmd_mag_improve(argv):
    """MAG improvement (projects/bin_analysis/bin_refinement.hpp): pull
    graph-connected neighbour unitigs into a MAG's contig set."""
    p = _parser("mag-improve")
    p.add_argument("graph_gfa")
    p.add_argument("mag", help="FASTA of the MAG's contigs")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--radius", type=int, default=1)
    p.add_argument("--max-added-length", type=int, default=100000)
    a = p.parse_args(argv)
    dev = _device(a)
    from .graph.from_gfa import graph_from_gfa
    from .graph.graph import edge_codes_host
    from .models import bio
    from .ops import dna
    from .vis import VisSession
    g = graph_from_gfa(a.graph_gfa, device=dev)
    names, seqs = _read_fasta(a.mag)
    mask = bio.fill_restricted_edges(g, seqs).cpu().numpy()
    base = set(int(e) for e in np.nonzero(mask)[0])
    sess = VisSession(device=dev)
    sess.g = g
    hv = sess.host()
    grown = set(base)
    for e in base:
        grown |= sess._neighborhood(e, a.radius)
    added = sorted(grown - base)
    total = 0
    with open(a.output, "w") as f:
        for name, s in zip(names, seqs):
            f.write(f">{name}\n{s}\n")
        conj_done = set()
        for e in added:
            if e in conj_done or total > a.max_added_length:
                continue
            conj_done.add(int(hv.conj[e]))
            s = dna.decode_codes(edge_codes_host(hv, e))
            total += len(s)
            f.write(f">added_edge_{e}_len_{len(s)}\n{s}\n")
    print(f"added {len(added)} neighbour edges ({total} bp)",
          file=sys.stderr)
    return 0


def cmd_corrector(argv):
    """Standalone post-assembly mismatch corrector
    (projects/corrector spades-corrector-core,
    dataset_processor.cpp:173 ProcessDataset): map reads onto the given
    contigs and fix positions by majority vote (no BWA subprocess: the
    batch mapper plays that role)."""
    p = _parser("corrector")
    p.add_argument("contigs", help="FASTA to polish")
    p.add_argument("reads", nargs="+")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-k", type=int, default=21,
                   help="mapping k-mer size")
    a = p.parse_args(argv)
    dev = _device(a)
    from .graph import construct
    from .graph.graph import edge_codes_host
    from .ops import dna
    from .pipeline import mismatch_correction
    names, seqs = _read_fasta(a.contigs)
    g = construct.graph_from_sequences(seqs, a.k, device=dev)
    b = _load(a.reads)
    g2, n = mismatch_correction.correct_mismatches(
        g, b.codes, b.lengths, device=dev)
    with open(a.output, "w") as f:
        for i, name in enumerate(names):
            s = dna.decode_codes(edge_codes_host(g2, 2 * i))
            f.write(f">{name}\n{s}\n")
    print(f"corrected {n} positions in {len(names)} contigs",
          file=sys.stderr)
    return 0


def cmd_truseq_analysis(argv):
    """Variation detection against an assembly graph
    (projects/truseq_analysis: VariationDetectionStage,
    analysis_pipeline.cpp:35-86 + AlignmentAnalyserNew.cpp:29-100):
    build the graph from the dataset reads, map each genome part onto
    it, merge connectable mapping runs, and report variations
    (Insertion/Deletion/Substitution, consistent_mapping.cpp:195-217)
    and breakpoints not explained by coverage dead-ends
    (analysis_pipeline.cpp CheckEndVertex)."""
    p = _parser("truseq-analysis")
    p.add_argument("--dataset", nargs="+", required=True,
                   help="read files the graph is built from")
    p.add_argument("--genome", required=True,
                   help="fasta of parts to analyse")
    p.add_argument("-k", type=int, default=55)
    p.add_argument("-o", "--output", default="-",
                   help="analysis_report path")
    a = p.parse_args(argv)
    dev = _device(a)
    from .graph import construct
    from .graph.host import edge_mask, host_view
    from .mapping import long_read
    from .ops import dna as dna_ops
    b = _load(a.dataset)
    g = construct.graph_from_reads(b.codes, b.lengths, a.k, device=dev)
    names, parts = _read_fasta(a.genome)
    pc, pl = dna_ops.encode_reads(parts)
    als = long_read.align_long_reads(g, pc, pl, device=dev)

    hv = host_view(g)
    start_v, end_v, elens, covs, conj = (hv.start_v, hv.end_v, hv.seq_len,
                                         hv.cov, hv.conj)
    alive = edge_mask(hv)
    out_edges = {}
    for e in np.nonzero(alive)[0]:
        out_edges.setdefault(int(start_v[e]), []).append(int(e))
    flat, starts_f = hv.seq_flat, hv.seq_start

    def edge_seq(e, lo, hi):
        return dna_ops.decode_codes(flat[starts_f[e] + lo:
                                         starts_f[e] + hi])

    def check_end_vertex(e, dist, depth=0):
        # CheckEndVertex (analysis_pipeline.cpp:114-129): the walk from
        # e dies out within dist -> the gap is a coverage break
        if covs[e] == 0:
            return True
        if elens[e] > dist or depth > 30:
            return False
        outs = out_edges.get(int(end_v[e]), [])
        return all(check_end_vertex(o, dist - int(elens[e]), depth + 1)
                   for o in outs)

    def classify(run, part_seq):
        # CompareToReference (consistent_mapping.cpp:195-217)
        ref_part = part_seq[run[0].read_lo:run[-1].read_hi]
        mapped = "".join(edge_seq(h.edge, h.edge_lo, h.edge_hi)
                         for h in run)
        if mapped == ref_part:
            return "Match"
        l = 0
        while (l < min(len(ref_part), len(mapped))
               and ref_part[l] == mapped[l]):
            l += 1
        r = 0
        while (l + r < min(len(ref_part), len(mapped))
               and ref_part[-1 - r] == mapped[-1 - r]):
            r += 1
        base = run[0].read_lo
        if l + r >= len(ref_part):
            return (f"Insertion ({base + l}): Length: "
                    f"{len(mapped) - l - r}")
        if l + r >= len(mapped):
            return (f"Deletion ({base + l + 1}, "
                    f"{run[-1].read_hi - r}): Length: "
                    f"{len(ref_part) - l - r}")
        return (f"Substitution ({base + l + 1}, "
                f"{run[-1].read_hi - r}): Lengths: "
                f"{len(ref_part) - l - r} -> {len(mapped) - l - r}")

    out = _out(a.output)
    slack = a.k
    for i, al in enumerate(als):
        out.write(f"Analysis of part {names[i]}\n")
        if not al.chain:
            continue
        # merge connectable hits into consistent mappings
        # (AlignmentAnalyserNew::Analyse + ExtractConsistentMappings)
        runs = [[al.chain[0]]]
        for h in al.chain[1:]:
            prev = runs[-1][-1]
            connected = (end_v[prev.edge] == start_v[h.edge]
                         and 0 <= h.read_lo - prev.read_hi <= slack)
            same_edge = (h.edge == prev.edge
                         and prev.edge_hi <= h.edge_lo + slack)
            if connected or same_edge:
                runs[-1].append(h)
            else:
                runs.append([h])
        for run in runs:
            initial = run[-1].read_hi - run[0].read_lo
            mapped = sum(h.edge_hi - h.edge_lo for h in run)
            if abs(initial - mapped) > 500:
                out.write(classify(run, parts[i]) + "\n")
        for cm, nxt in zip(runs, runs[1:]):
            e_end = cm[-1].edge
            e_next = int(conj[nxt[0].edge])
            tail = int(elens[e_end]) - cm[-1].edge_hi
            head = nxt[0].edge_lo
            if (check_end_vertex(e_end, 150 + tail)
                    and check_end_vertex(e_next, 150 + head)):
                continue  # coverage break: reference logs nothing
            len_a = cm[-1].read_hi - cm[0].read_lo
            len_b = nxt[-1].read_hi - nxt[0].read_lo
            if len_a < 100 or len_b < 100:
                continue  # unreliable alignment event
            out.write(f"Breakpoint: [{cm[-1].read_hi}, "
                      f"{nxt[0].read_lo}]\n")
    _close(out)
    return 0


def cmd_truspades(argv):
    """truSPAdes: per-barcode assembly of TruSeq synthetic long reads
    (assembler/truspades.py + spades_pipeline/truspades/: extract
    barcodes -> assemble each barcode's read set -> merged TSLR FASTA,
    then scaffold correction via 'tools scf-correction'). Each barcode
    runs the port's command line (``cli.main``) with this ``--device``."""
    p = _parser("truspades")
    p.add_argument("--input-dir", dest="input_dirs", action="append",
                   required=True,
                   help="directory of per-barcode read files; mate pairs "
                        "are <barcode>_1/<barcode>_2, else single")
    p.add_argument("-o", "--output-dir", required=True)
    p.add_argument("-k", type=int, default=21)
    a = p.parse_args(argv)
    dev = _device(a)
    from . import cli
    os.makedirs(a.output_dir, exist_ok=True)
    # barcode extraction (truspades/barcode_extraction.py role): group
    # files by <barcode>[_12] stem
    barcodes: dict[str, dict] = {}
    for d in a.input_dirs:
        for fn in sorted(os.listdir(d)):
            m = re.match(r"(.+?)(?:_(1|2))?\.(fastq|fq|fasta|fa)"
                         r"(\.gz)?$", fn)
            if not m:
                continue
            bc, mate = m.group(1), m.group(2)
            rec = barcodes.setdefault(bc, {})
            rec[mate or "s"] = os.path.join(d, fn)
    n_ok = 0
    tslr_path = os.path.join(a.output_dir, "TSLR.fasta")
    with open(tslr_path, "w") as tslr:
        for bc, rec in sorted(barcodes.items()):
            out = os.path.join(a.output_dir, "barcodes", bc)
            args = ["-o", out, "--only-assembler", "-k", str(a.k),
                    "--device", dev.type]
            if "1" in rec and "2" in rec:
                args += ["-1", rec["1"], "-2", rec["2"]]
            elif "s" in rec:
                args += ["-s", rec["s"]]
            else:
                continue
            if cli.main(args) != 0:
                print(f"barcode {bc}: assembly failed", file=sys.stderr)
                continue
            names, seqs = _read_fasta(os.path.join(out, "contigs.fasta"))
            for i, s in enumerate(seqs):
                tslr.write(f">{bc}_{i}_len_{len(s)}\n{s}\n")
            n_ok += 1
    print(f"assembled {n_ok}/{len(barcodes)} barcodes -> {tslr_path}",
          file=sys.stderr)
    return 0 if n_ok else 1


def cmd_bin_converter(argv):
    """Convert a pipeline save's packed read store back to FASTQ
    (projects/bin_converter spades-convert-bin-to-fasta). The saves of
    the port and of the JAX package are one format."""
    p = _parser("bin-converter")
    p.add_argument("save_dir", help="a saves/<stage> directory")
    p.add_argument("-o", "--output", required=True)
    a = p.parse_args(argv)
    dev = _device(a)
    from .io import fastq
    from .pipeline.stages import PipelineContext
    ctx = PipelineContext.load(a.save_dir, device=dev)
    lengths = ctx.lengths.cpu().numpy()
    fastq.write_reads_fastq(a.output, ctx.codes.cpu().numpy(), lengths)
    print(f"{len(lengths)} reads -> {a.output}", file=sys.stderr)
    return 0


TOOLS = {
    "gbuilder": cmd_gbuilder,
    "kmercount": cmd_kmercount,
    "kmer-estimating": cmd_kmer_estimating,
    "read-filter": cmd_read_filter,
    "gsimplifier": cmd_gsimplifier,
    "gmapper": cmd_gmapper,
    "kmer-multiplicity-counter": cmd_kmer_multiplicity_counter,
    "contig-abundance": cmd_contig_abundance,
    "prop-binning": cmd_prop_binning,
    "vis": cmd_vis,
    "scf-correction": cmd_scf_correction,
    "unitig-coverage": cmd_unitig_coverage,
    "cds-subgraphs": cmd_cds_subgraphs,
    "mag-improve": cmd_mag_improve,
    "bin-converter": cmd_bin_converter,
    "corrector": cmd_corrector,
    "truspades": cmd_truspades,
    "truseq-analysis": cmd_truseq_analysis,
    "edge-positions": cmd_edge_positions,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    tool = argv[0]
    if tool not in TOOLS:
        print(f"unknown tool {tool!r}; available: {', '.join(TOOLS)}",
              file=sys.stderr)
        return 2
    try:
        return TOOLS[tool](argv[1:])
    except _NoCard as e:
        print(f"{tool}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
