#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card and
the CUDA toolkit):

    python3 chip_smoke.py [--out result.json]

Phases, each of which raises on failure (the script then exits 1 and
prints no result):

1. the card's name and power limit (nvidia-smi); build of the port's
   four CUDA kernels from ``spades_for_blackbird_tpu_torch/csrc`` (the
   k-mer extraction, the banded edit distance, the Viterbi and the
   ordered segment sum), one ``nvcc`` a source, all started together;
2. kernel vs its plain PyTorch version on the card: simulated reads
   with N bases and short reads, L = 100 and 150, k+1 in
   {22, 34, 56, 78, 128} at nine fixed chunk shapes, the three shapes
   the full-size runs give the kernel (all their reads in one chunk at
   k+1 = 22, 34 and 56, the rungs of the default ladder), and small
   ragged shapes (a last tile that is not full, one read, reads of
   length 0, a misaligned view);
   sort keys and validity must be bit-equal; so must the strand entry's
   keys, validity and strand byte (``kmer_cuda.extract_canonical_keys``)
   at every one of those shapes and at the error corrector's own (L = 100,
   k = 21: all 1.84M reads, and the chunks its statistics, expansion and
   voting passes take); CUDA events time the bare kernel launch, the
   wrapper (the call the counter makes: allocation and launch) and the
   plain version, beside the bound: the larger of the bytes the kernel
   must move over the card's memory rate and its integer operations over
   the card's instruction rate; ``count_kmers`` on one chunk is timed too;
   at the corrector's shapes the launch is timed with and without the
   strand byte; so it is at the read mapper's (L = 100, k+1 = 56, one
   mate of the 4.6 Mb simulation: 920,000 reads) and at the edge index's
   (the flat sequence of a 4.6 Mb graph cut into rows of 4096 bases that
   overlap by k bases, the last one ragged); then the two hand kernels
   with no TPU counterpart against their plain versions: ``banded_ed``
   at the hybrid stages' shapes (B = 1-8, L up to 2,000, band 48) and
   ragged ones (lengths 0 and 1, a length difference past the band), and
   ragged pairs at bands 0, 1, 15, 16 and 511 (one to 32 slots a lane),
   bit-equal; ``viterbi`` at profile lengths 120, 300 and 512 (the warp
   path), 1,100 and 2,048 (the block path, one and two nodes a
   thread) and 2,049, 4,000 and 5,000 (the tile path: node tiles of
   2,048), bit-equal at every position within a row's length, and
   batched: 12 profiles of 135-294 nodes over 12 ragged rows of up to
   3,000 positions in one call, bit-equal everywhere to the plain
   batched version on the rows cut to 400 positions; the bare launches
   timed beside their bound and the plain versions, the block and the
   tile path a position;
3. ``assemble_single_k`` at k=21 on a 20 kb simulated genome on the card
   and on the CPU: identical canonical contigs, coverages within
   rtol 1e-4 (float32 sums run in another order on the card); the
   kernel against its plain version on the contig windows
   (``_windows_from_sequences``) of that assembly at k+1 = 34 and 56,
   aligned and as a misaligned view; then the same reads as a FASTQ file
   through the command line twice, ``--device cuda`` and ``--device
   cpu``, at -k 21,33 (21,33,55 until phases 12-14 came; the later
   command lines of this phase run at -k 21 since phase 15 came):
   identical contig sequences,
   coverages within
   rtol 1e-4, identical GFA segments and links; the error corrector on
   the same reads with their qualities (``correct_reads``) on the card
   and on the CPU: identical corrected codes and stats; the default
   command (correction, then the ladder) through the command line on
   both: identical contigs; ``--iontorrent --only-error-correction`` on
   both: identical corrected reads; the paired default command (``-1/-2``
   with qualities, correction, gap closing, repeat resolution) on both:
   identical contig and scaffold sequences, coverages within rtol 1e-4,
   identical GFA segments, links and P-lines, equal ``contigs.paths``,
   ``scaffolds.paths`` and ``final.lib_data``; the same for ``-1/-2
   --only-assembler --careful``, ``-1/-2 --only-assembler --sc`` and
   ``-1/-2 --only-assembler --assembly-graph`` on the GFA the paired run
   wrote on the card; and ``assemble_single_k(restricted_sequences=...)``
   at k=21 on the reads plus a weak second allele (2 kb, 4 SNPs, half the
   coverage), restricted by the 43-base windows centred on its SNPs:
   identical contigs, every window kept; then the modes on FR pairs of a
   26 kb community (a 15 kb and an 8 kb genome at 40x, a 3 kb circle at
   60x) through the command line on both: ``--meta -k 21`` (21,33
   until phase 15 came),
   ``--plasmid``, ``--metaplasmid``, ``--metaviral``, ``--rnaviral``,
   ``--rna --ss fr`` and ``--moleculo`` at ``-k 21``, all
   ``--only-assembler``: identical contigs, scaffolds, ``.paths``,
   ``final.lib_data``, GFA segments, links and P-lines, and identical
   ``contigs.circular.fasta``, ``contigs.linears.fasta`` and
   ``components_*.fasta`` (coverages in the headers within rtol 1e-4);
   and the hybrid, HMM and series command lines at ``-k 21
   --only-assembler`` on FR pairs of a 12 kb genome with two planted
   domains: ``--pacbio`` and ``--sanger`` (a 600 bp hole in the pairs,
   ten noisy long reads across it), ``--bio --custom-hmms`` and
   ``--corona --custom-hmms``, ``--series-analysis`` (a two-sample
   profile): identical FASTA, paths, GFA, HMM and series files;
4. the full-size run: ``assemble_single_k`` at k=55 on a simulated
   E. coli-sized genome (4.6 Mb, seed 7, 40x, 100 bp paired reads,
   error rate 0.002, planted repeats), graded against the truth with
   ``utils/assess``: genome fraction >= 0.97 and no misassembly; the
   kernel's launch count over the run must be positive; then the kernel
   against its plain version on the contig windows of this assembly, at
   k+1 = 34 and 56: the row counts the ladder's later rungs hand it; and
   on the rows the edge index of this graph hands it (k+1 = 56, timed
   beside the bound);
5. (the profile of phase 4's assembly under ``torch.profiler`` was cut
   when phases 12-14 came, to keep the smoke inside its time);
6. the ladder through the command line on a 500 kb simulation of the
   same kind (4.6 Mb until the error corrector came, whose five stage
   saves alone took 3 minutes there; 1 Mb until phases 12-14 came): the
   reads written as one FASTQ file, then
   ``cli.main(["-s", fq, "-o", out, "--only-assembler", "--trace-time"])``,
   the default ladder 21, 33, 55, default checkpoints. It must return 0,
   meet the same quality bar on ``contigs.fasta``, write a GFA that reads
   back with one segment a live edge pair, and launch the kernel at least
   5 times (3 rungs on the reads, 2 on contig windows). Wall seconds of
   the call, of each stage, of ``count_extra_contigs`` and of the
   checkpoint saves are printed, and the peak device memory;
   ``--continue`` on the finished directory must return 0 and run no
   stage;
7. the error corrector at full size: the 4.6 Mb simulation of phase 4
   with its qualities; the true reads are phase 4's reads before their
   errors were drawn. (a) ``correct_reads
   on the card, timed by scope: bases wrong before and after, bases it
   made wrong; at most a quarter of the wrong bases may be left. (b) the
   default command, ``cli.main(["-s", fq, "-o", out, "--checkpoints",
   "none", "-k", "55", "--trace-time"])`` (the whole ladder until phase
   16 came) on the reads written with their qualities:
   it must return 0, meet the quality bar on ``contigs.fasta`` and log
   (a)'s correction stats ((a)'s rerun under ``torch.profiler``, the
   card's busy share, was cut when phase 16 came). The kernel must
   launch inside the corrector,
   and while this phase runs the plain extraction raises if it is handed
   a tensor on the card. Wall, stages, the corrector's scopes and the
   peak device memory are printed;
8. the paired default command at full size: the reads of phase 4 as two
   FASTQ files with qualities (first and second mates), then
   ``cli.main(["-1", f1, "-2", f2, "-o", out, "--checkpoints", "none",
   "--trace-time"])``: correction, the ladder, gap closing, paired repeat
   resolution. It must return 0, meet the quality bar on ``contigs.fasta``
   and on ``scaffolds.fasta`` with the N's removed, and launch the kernel
   inside gap closing and inside repeat resolution, while the plain
   extraction raises if it is handed a tensor on the card. NG50 of both
   is printed beside the JAX package's record of the same simulation
   (quality only), and the insert size, the wall, the stages, the
   mapping and repeat-resolution scopes, the peak device memory and the
   launches (its rerun under ``torch.profiler`` was cut when phases 12-14
   came, to keep the smoke inside its time). The mates and the GFA stay
   for phases 9 and 11;
9. careful mode at full size: (a) ``correct_mismatches`` on phase 4's
   k=55 graph with 1,000 planted base errors (edges over 1 kb, at least
   200 bases from their ends and 500 apart, mirrored on the conjugate
   edges), using phase 4's reads: every planted base must be fixed; the
   other bases it changed are counted (expected 0), timed by scope, with
   launches and peak memory; (b) phase 8's command with ``--careful``
   at ``-k 55`` (the whole ladder until phase 15 came):
   return 0, the quality bar on contigs and scaffolds, the kernel
   launched at least twice inside ``correct_mismatches``;
10. ``--sc`` on uneven coverage: the first third of the 4.6 Mb genome
   (the whole until phase 15 came, its first half until phase 16 came),
   coverage
   constant over 5 kb blocks, ``clip(40 * exp(0.8 z), 8, 200)`` a block,
   phase 8's reads otherwise, as two FASTQ files with qualities;
   ``cli.main(["-1", f1, "-2", f2, "-o", out, "--sc", "--checkpoints",
   "none", "--trace-time"])`` must return 0, make 0 misassemblies and
   reach genome fraction >= 0.95 on contigs (the wall, the stages, the
   scopes ``rcc``, ``topology_block`` and ``hidden_ec``, NG50 and the
   peak memory are printed); then ``assemble_single_k(...,
   uneven_depth=True)`` at k=55 (k=21 too until phases 12-14 came) on
   the same reads, the bound it
   takes and its scope's time beside the spectrum fit's bound;
11. the fork's paths at full size: (a) phase 4's reads plus a 20 kb
   variant copy (40 SNPs 500 bases apart, at 40x; its run at 20x was cut
   when phases 12-14 came) through
   ``assemble_single_k`` at k=55 without and with the 40 windows of 111
   bases centred on its SNPs as ``restricted_sequences``: with them every
   window must lie in an alive edge (either strand), without them the
   count kept is printed, beside the launches inside ``simplify`` and the
   walls; (b) phase 8's reads with ``--only-assembler --assembly-graph``
   on phase 8's GFA: return 0 and the quality bar on contigs and
   scaffolds;
12. the metagenome, cut to half its size when phase 15 came, to 0.35
   of it when phase 16 came and to 0.25 when the tile path and seg_sum's
   new shapes came (META_SCALE): four genomes of 0.5, 0.375, 0.25 and
   0.125 Mb (2.0, 1.5, 1.0 and 0.5 Mb at first; seeds
   21-24, GC 0.40, 0.50, 0.60, 0.45, phase 4's planted repeats) at
   80, 40, 20 and 8x, a 20 kb window of the first copied into the second
   with 1% substitutions, a 12 kb and a 60 kb circular plasmid at 10 and 3
   copies of the first genome and a 45 kb circular phage at 150x, as FR
   pairs (100 bp, insert 300 +- 25, error rate 0.002, qualities): (a)
   ``-1/-2 --meta``: return 0, each genome at >= 20x at genome fraction
   >= 0.95 and no genome with a misassembly outside the island's windows
   (each graded with ``utils/assess`` on the contigs whose 21-mers come
   mostly from it), the kernel launched inside ``second_phase_setup``;
   (b) ``--metaplasmid --only-assembler -k 55`` and (c) ``--metaviral
   --only-assembler -k 55`` on the same reads (one rung: without the
   correction each rung takes 2.5 times as long): return 0, each circle
   held at
   >= 90% of its 21-mers by one record of ``components_*.fasta`` or
   ``contigs.circular.fasta``; (c) writes ``contigs.linears.fasta`` and
   lists the phage as circular;
13. ``-1/-2 --plasmid -k 55`` (the whole ladder until phase 15 came) on
   phase 8's reads plus a 12 kb and a 60 kb
   circular plasmid at 10 and 3 copies: return 0, each plasmid held at
   >= 90% by one record of ``contigs.fasta`` or
   ``contigs.circular.fasta``;
14. RNA at full size: (a) ``-1/-2 --rna --ss fr -k 49`` (one rung of the
   rna ladder: the coverage fit takes about 100 s a rung on this
   spectrum) on stranded FR pairs (100 bp, insert 250 +- 25) of 1,000
   simulated genes (1,500 until the tile path and seg_sum's new shapes
   came; 2-6 exons, 1-3 isoforms skipping an exon, 10%
   overlapping their neighbour antisense, log-normal expression, median
   20x), at most 2M pairs: return 0, the kernel launched inside
   ``ss_edge_split``, at least ``ISOFORM_BAR`` of the isoforms at >= 20x
   held at >= 90% of their 21-mers by one contig (the share the JAX
   package's own strand split leaves, PERF.md); (b)
   ``-1/-2 --rnaviral`` on a 30 kb virus as three haplotypes (0, 1 and 3%
   apart, 80/15/5 at 1,000x; 2,000x until phase 16 came): return 0, the
   major haplotype at genome fraction >= 0.95.

15. hybrid long reads, the HMM modes and the series analysis at full
   size, on phase 8's genome with 8 clusters of 3-5 reverse-translated
   domains (12 domains of 120-300 aa, 1-5 kb apart) planted, and its FR
   pairs at 40x with qualities: (a) ``-1/-2 --nanopore -k 55`` (the
   ladder until the tile path and seg_sum's new shapes came) with every
   pair that has a mate in one of 24 holes of 400-1,000 bases dropped
   and long reads at 5x (2-20 kb, 10% errors split evenly between
   substitutions, insertions and deletions): return 0, genome fraction
   >= 0.97 of the genome outside the holes, no misassembly in a record
   that does not reach a hole; the holes one record spans (both
   100-mers 50 bases outside the hole) and the joins of each hybrid
   stage printed, with no floor at this size (random 15-mers of the
   long reads break the JAX package's seed chains inside the holes,
   ROADMAP Queue 3, item 14); then the same on the 1/20 cut of this
   data (230 kb, no clusters): a quarter of the holes spanned at
   least, ``banded_ed`` launched; (b)
   ``-1/-2 --bio --custom-hmms -k 55`` (the ladder until then) with the
   12 profiles
   (``hmm_from_consensus``, written with ``write_hmm_file``): return 0,
   every cluster in ``gene_clusters.fasta`` with its domains in order;
   one ``viterbi`` launch in each HMM stage (``extract_domains`` and
   ``domain_graph_construction``); then the batched launch of all 12
   profiles on the run's own rows (six frames of every contig, ragged)
   held against the plain version of the shortest and the longest
   profile on each row cut to its first 4,000 positions, and timed on
   the full rows, beside the longest row alone; one profile on the
   padded rows timed as before;
   (c) three samples of phase 12's four genomes at their coverages
   rotated a step a sample: their profile counted on the card and saved
   in the JAX package's ``.npz``, then ``-1/-2 --only-assembler -k 55
   --series-analysis`` on the first: every genome's edges of 1 kb or
   more at median sample ratios within 20% of the planted ones. Wall,
   peak memory and each kernel's launches (by stage) are printed for
   every run.

16. the tools (``python -m spades_for_blackbird_tpu_torch.tools``) at
   full size, each through ``tools.main`` on the card with every
   kernel's count at 0 before it (wall, peak memory and launches
   printed): ``gbuilder -k 55 --min-count 3`` on phase 8's reads, then
   ``gsimplifier``, ``unitig-coverage`` and ``edge-positions`` on its
   GFA (the ranges must cover 0.97 of the genome); ``kmercount`` and
   ``kmer-estimating`` at k = 21 (the estimate within 6% of the distinct
   count); ``read-filter``; ``gmapper`` with phase 15 (a)'s long reads on
   phase 15 (b)'s graph (the aligned share printed, no floor);
   ``scf-correction`` of phase 8's contigs with 40 planted runs of 100
   N's (the gaps filled printed); ``cds-subgraphs`` with phase 15 (b)'s
   profiles (``viterbi`` launched); ``prop-binning``,
   ``kmer-multiplicity-counter`` and ``contig-abundance`` on phase 12's
   community; then ``assemble_single_k`` at k = 55 with the max-flow EC
   remover on phase 10's uneven reads: genome fraction >= 0.95 and no
   misassembly.

The float sums of every phase run through the ``seg_sum`` kernel
(``csrc/seg_sum.cu``: the rows of a scatter-add sorted by slot, each
slot's run added in row order, short runs a thread from a tile in
shared memory, long runs a block streaming them through a ring to one
adding warp): phase 1 builds it, phase 2 times one thread's chain of
dependent adds (the chain bound) and holds the kernel bit-equal to its
plain version (the CPU's ``index_add_`` on the same rows), on the rows
copied out in sorted order and read through the permutation, with
int32 and int64 slots, at synthetic shapes (most rows on three slots;
uniform; the corrector's (N, 21) quality sums; float64 moments; one
run of 1.2 million rows; mixed run lengths at C = 21), each timed as
the route launches it beside its byte and chain bounds, phase 3
holds
``drop_scatter``'s float sum on the card to the CPU's bits in five calls
on a collision-heavy scatter, runs the 20 kb ``--careful`` command
three times on the card against the CPU's one run (byte-identical
files), and runs each of the 19 tools on a 20 kb genome on the card and
on the CPU (a child process): the same files and output, a number
printed with d decimals within 10^-d; phase 4 holds its assembly's
largest float sum (condense's coverage sums at k = 55) to the CPU's
bits in five calls and times the kernel there, beside its bound, its
plain version and ``index_add_`` on the card.

Phases 9-16 run with the plain versions of the kernels refused on the
card. Each phase's wall is printed as ``[timing]``. ``--only PHASES``
runs some of the phases that need no other (for a short check) and
prints no result.

Without a CUDA card, or outside a checkout of the repository, it exits
2 before printing any result. The last two lines of standard output are
the kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "spades_for_blackbird_tpu_torch"
KERNEL_SOURCE = f"{PACKAGE}/csrc/kmer_extract.cu"
TPU_KERNEL = "spades_for_blackbird_tpu/ops/kmer_pallas.py:31"
# (L, k+1, reads): the (k+1)-mer sizes of the K ladders at one counting
# chunk each
SMOKE_SHAPES = (
    (100, 22, 1 << 20), (100, 34, 1 << 20), (100, 56, 1 << 20),
    (100, 78, 1 << 21),
    (150, 22, 1 << 19), (150, 34, 1 << 19), (150, 56, 1 << 19),
    (150, 78, 1 << 19), (150, 128, 1 << 20))
# (L, k, reads) that leave a ragged last tile, one read, one window a
# read, an alignment unit of 16 reads, the longest row
RAGGED_SHAPES = ((100, 56, 100_003), (100, 56, 1), (40, 5, 1), (40, 5, 333),
                 (150, 128, 77), (33, 16, 50), (100, 100, 9), (4096, 127, 3))
FULL_K = 55
LADDER_KS = (21, 33, 55)  # the default ladder for 100 bp reads
HAMMER_K = 21  # BayesHammer's k (make_error_correction)
# the JAX package's record of phase 8's run (SCALE_r05_46m.json): NG50 of
# the contigs and of the scaffolds; quality only, no time of it is quoted
JAX_NG50 = {"contigs": 498_888, "scaffolds": 498_943}
RR_SCOPES = ("gc_build_index", "gc_map_reads", "rr_build_index",
             "rr_map_reads", "rr_pair_fill", "rr_resolve_paths",
             "rr_scaffold")
FULL_GENOME = 4_600_000  # E. coli size, as scale_bench.py's 4.6 Mb run
LADDER_GENOME = 500_000  # phase 6: the checkpointed ladder's cut size
META_SCALE = 0.25       # phases 12 and 15 (c): the community's genomes cut
SC_GENOME = FULL_GENOME // 2  # phase 10: the genome's first half
HAMMER_SCOPES = ("hammer_count", "hammer_cluster", "hammer_subcluster",
                 "hammer_expand", "hammer_vote")
FULL_COVERAGE = 40.0
FULL_READ_LEN = 100
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
# The data sheet names no integer rate. 32-bit integer instructions run
# at most as fast as float32 FMAs outside the tensor cores (67 TFLOP/s,
# two operations an FMA), so that rate bounds them from above.
INT_OPS_PER_S = 67e12 / 2
COV_RTOL = 1e-4
# phase 3: the command lines' CPU runs, child processes beside the card's
CPU_RUN_WIDTH = 6       # at once
CPU_RUN_THREADS = 1     # each
CPU_RUN_TIMEOUT = 900
CAREFUL_ERRORS = 1000  # phase 9: bases planted in the k=55 graph
SC_BLOCK = 5000        # phase 10: bases of constant coverage
SC_FRACTION = 0.95     # phase 10: genome fraction bar of --sc contigs
SC_SCOPES = ("rcc", "topology_block", "hidden_ec")
VARIANT_SNPS = 40      # phase 11: SNPs of the variant copy, 500 bases apart
VARIANT_AT = 1_000_000  # phase 11: where in the genome the copy starts
# phase 11: the copy's coverage in the checked runs, the main copy's: at
# half of it the erroneous-connection remover (which the restricted-edge
# mask does not cover, in either package) takes some allele edges
VARIANT_COVERAGE = FULL_COVERAGE


def log(msg: str) -> None:
    print(msg, flush=True)


def encode_fixed(reads: list[str]) -> np.ndarray:
    """Equal-length ASCII reads -> (R, L) uint8 codes."""
    from spades_for_blackbird_tpu_torch.ops import dna
    return dna.encode_str("".join(reads)).reshape(len(reads), len(reads[0]))


def simulate_reads(genome_size: int, coverage: float, read_len: int,
                   seed: int, error_rate: float = 0.002, truth: bool = False):
    """scale_bench.py's simulation: planted repeats, FR pairs, insert 300.
    Returns (genome, codes (R, L) uint8, lengths (R,) int32, quals (R, L)
    uint8 phred+33), and with ``truth`` the reads' codes without their
    errors too."""
    from spades_for_blackbird_tpu_torch.utils import simulate
    genome = simulate.random_genome(genome_size, seed=seed,
                                    repeats=[(2000, 3), (700, 4), (400, 6)])
    n_pairs = int(coverage * genome_size / (2 * read_len))
    codes, quals, true_codes = paired_codes(
        genome, n_pairs, read_len, 300.0, 25.0, error_rate, seed + 1)
    out = (genome, codes, np.full(codes.shape[0], read_len, np.int32),
           quals)
    return out + (true_codes,) if truth else out


def paired_codes(genome: str, n_pairs: int, read_len: int,
                 insert_mean: float, insert_sd: float, error_rate: float,
                 seed: int):
    """``utils/simulate.py::simulate_paired_reads`` with the same random
    numbers, kept as arrays: (codes (2n, L) uint8, first mates then
    second mates; their phred+33 qualities; the codes without the
    errors). The same reads, without a string a read in between."""
    from spades_for_blackbird_tpu_torch.ops import dna
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGTN", b"TGCAN"):
        comp[a] = b
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome.encode("ascii"), dtype=np.uint8)
    L = len(g)
    ins = np.clip(rng.normal(insert_mean, insert_sd, n_pairs).astype(int),
                  read_len, None)
    start = rng.integers(0, np.maximum(L - ins, 1), n_pairs)
    fwd = rng.random(n_pairs) < 0.5
    offs = np.arange(read_len)
    r1 = g[np.minimum(start[:, None] + offs[None, :], L - 1)]
    r2 = g[np.minimum(start[:, None] + (ins - read_len)[:, None]
                      + offs[None, :], L - 1)]
    r2 = comp[r2[:, ::-1]]
    r1, r2 = (np.where(fwd[:, None], r1, comp[r2[:, ::-1]]),
              np.where(fwd[:, None], r2, comp[r1[:, ::-1]]))
    true_reads = np.concatenate([r1, r2])

    def add_errors(reads):
        err = rng.random(reads.shape) < error_rate
        shift = rng.integers(1, 4, reads.shape)
        reads = reads.copy()
        reads[err] = alpha[(dna._CHAR_TO_CODE[reads[err]].astype(np.int64)
                            + shift[err]) % 4]
        qual = np.where(rng.random(reads.shape) < 0.01, 12, 38).astype(
            np.uint8)
        qual[err & (rng.random(reads.shape) < 0.7)] = 8
        return reads, qual + 33

    r1, q1 = add_errors(r1)
    r2, q2 = add_errors(r2)
    to_codes = dna._CHAR_TO_CODE
    return (to_codes[np.concatenate([r1, r2])],
            np.concatenate([q1, q2]).astype(np.uint8),
            to_codes[true_reads])


def write_fastq(path: str, codes, quals) -> None:
    """Equal-length reads with their qualities as one FASTQ file, written
    in bulk: one text row a read."""
    from spades_for_blackbird_tpu_torch.ops import dna
    R, L = codes.shape
    with open(path, "wb") as f:
        for lo in range(0, R, 1 << 18):
            c = dna.CODE_TO_CHAR[np.minimum(codes[lo:lo + (1 << 18)], 4)]
            q = quals[lo:lo + (1 << 18)]
            n = c.shape[0]
            names = np.char.encode(np.char.add(
                "@read_", np.arange(lo, lo + n).astype(str)))
            f.write(b"".join(
                b"%s\n%s\n+\n%s\n" % (name, cr.tobytes(), qr.tobytes())
                for name, cr, qr in zip(names, c, q)))


def card_name() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi gave no answer"


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` calls,
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> dict:
    """Build every kernel of the port from the checkout's sources: one
    ``nvcc`` a source, all started together."""
    from spades_for_blackbird_tpu_torch.ops import cuda_build
    kernels = all_kernels()
    t0 = time.perf_counter()
    cuda_build.build_all(k.library for k in kernels.values())
    seconds = time.perf_counter() - t0
    out = {"build_s": seconds}
    for name, kernel in kernels.items():
        lib = kernel.library
        usage = [ln.strip() for ln in lib.ptxas_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {lib.library_path()} (nvcc "
            f"{lib.build_seconds:.2f} s)")
        for ln in usage or ["cached build"]:
            log(f"[build] {name} ptxas: {ln}")
        out[name] = {"nvcc_s": lib.build_seconds, "ptxas": usage}
    log(f"[build] all kernels in {seconds:.2f} s")
    return out


def sampled_reads(rng, n_reads: int, read_len: int, coverage: float = 40.0,
                  error_rate: float = 0.002):
    """Reads for the kernel's comparison and timing, drawn in bulk: both
    strands of a random genome at ``coverage``, with substitutions.
    Returns (codes (R, L) uint8, lengths (R,) int32)."""
    genome = rng.integers(0, 4, int(n_reads * read_len / coverage) + read_len,
                          dtype=np.uint8)
    starts = rng.integers(0, len(genome) - read_len + 1, n_reads)
    codes = np.lib.stride_tricks.sliding_window_view(genome, read_len)[starts]
    reverse = rng.random(n_reads) < 0.5
    codes[reverse] = 3 - codes[reverse][:, ::-1]
    errors = rng.integers(0, codes.size, rng.binomial(codes.size, error_rate))
    flat = codes.reshape(-1)
    flat[errors] = (flat[errors] + rng.integers(1, 4, len(errors),
                                                dtype=np.uint8)) & 3
    return codes, np.full(n_reads, read_len, np.int32)


def noisy_reads(rng, codes, lengths):
    """N bases, short reads (5%, some of length 0) and padding."""
    L = codes.shape[1]
    codes[rng.random(codes.shape) < 0.002] = 4
    short = np.nonzero(rng.random(len(lengths)) < 0.05)[0]
    lengths[short] = rng.integers(0, L, len(short))
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 4
    return codes, lengths


def kernel_bytes(R: int, L: int, k: int, strand: bool = False) -> int:
    """What the kernel must move: every code and length read once, every
    key (and, where k % 16 == 0, validity byte; with ``strand`` the
    strand byte) written once."""
    windows = R * (L - k + 1)
    key_cols = ((k + 15) // 16 + 1) // 2
    return (R * L + 4 * R
            + (8 * key_cols + (k % 16 == 0) + strand) * windows)


def kernel_ops(R: int, L: int, k: int) -> int:
    """The least 32-bit integer operations the function needs: a shift a
    word and strand, a compare and a select a word, a fuse a key, for
    every window; two packing operations a base and strand."""
    words = (k + 15) // 16
    windows = R * (L - k + 1)
    return windows * (4 * words + (words + 1) // 2) + 4 * R * L


def bound_of(R: int, L: int, k: int, strand: bool = False):
    """(bound ms, what bounds it, bytes moved)."""
    moved = kernel_bytes(R, L, k, strand)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = kernel_ops(R, L, k) / INT_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", moved)


def outputs_err(k, keys, valid, ref_keys, ref_valid) -> float:
    """The largest absolute difference of the unfused words and validity
    of two extractions (0.0: bit-equal)."""
    from spades_for_blackbird_tpu_torch.ops import dna, segments
    import torch
    if (valid is None) != (ref_valid is None):
        return float("inf")
    err = 0.0
    if valid is not None and not torch.equal(valid, ref_valid):
        err = 1.0
    if not torch.equal(keys, ref_keys):
        W = dna.words_per_kmer(k)
        for g in range(keys.shape[0]):  # one key column at a time
            diff = segments.unfuse_keys([keys[g]], min(2, W - 2 * g)) - \
                segments.unfuse_keys([ref_keys[g]], min(2, W - 2 * g))
            err = max(err, float(diff.abs().max()))
    return err


def compare_kernel(kernel, c, ln, k) -> float:
    """Kernel vs plain version on the same tensors, both entries: sort
    keys, validity and strand bytes (0.0: bit-equal)."""
    import torch
    from spades_for_blackbird_tpu_torch.ops import kmer
    err = outputs_err(k, *kernel(c, ln, k), *kmer.extract_sort_keys(c, ln, k))
    keys, valid, fwd = kernel.canonical_keys(c, ln, k)
    ref_keys, ref_valid, ref_fwd = kmer.extract_canonical_keys(c, ln, k)
    torch.cuda.synchronize()
    err = max(err, outputs_err(k, keys, valid, ref_keys, ref_valid))
    if not torch.equal(fwd, ref_fwd):
        err = max(err, 1.0)
    return err


def phase_kernel_vs_plain(device) -> dict:
    """Bit-equality and timing of the kernel against the plain version."""
    import torch
    from spades_for_blackbird_tpu_torch.hammer import bayes, correct
    from spades_for_blackbird_tpu_torch.kmers import counter
    from spades_for_blackbird_tpu_torch.ops import kmer, kmer_cuda

    kernel = kmer_cuda.extract_sort_keys
    rng = np.random.default_rng(11)

    ragged = []
    for L, k, R in RAGGED_SHAPES:
        codes, lengths = noisy_reads(
            rng, rng.integers(0, 4, (R + 1, L), dtype=np.uint8),
            np.full(R + 1, L, np.int32))
        c_all = torch.from_numpy(codes).to(device)
        ln_all = torch.from_numpy(lengths).to(device)
        # rows 0..R-1 start on the storage's boundary; rows 1..R start L
        # bytes in, which is no 16-byte boundary for these L but 4096
        for name, lo in (("aligned", 0), ("offset view", 1)):
            err = compare_kernel(kernel, c_all[lo:lo + R],
                                 ln_all[lo:lo + R].contiguous(), k)
            ragged.append({"L": L, "k": k, "R": R, "view": name,
                           "max_abs_err": err})
            log(f"[kernel] ragged L={L} k={k} R={R} ({name}): "
                f"max_abs_err={err}")
            if err != 0.0:
                raise AssertionError(
                    f"kernel != plain at L={L} k={k} R={R} ({name})")

    # the shapes the full-size runs hand the kernel, one a rung of the
    # default ladder: all the reads, or the counting chunk where the
    # card's free memory allows fewer
    full_reads = 2 * int(FULL_COVERAGE * FULL_GENOME / (2 * FULL_READ_LEN))
    main_shapes = tuple(
        (FULL_READ_LEN, k + 1, min(full_reads, counter.chunk_reads_for(
            FULL_READ_LEN, k + 1, device)))
        for k in LADDER_KS)
    # the error corrector's: its k-mers over all the reads, and the chunks
    # its statistics, expansion and voting passes take
    hammer_shapes = tuple(dict.fromkeys(
        (FULL_READ_LEN, HAMMER_K, min(full_reads, n)) for n in (
            full_reads,
            bayes.stats_chunk_reads(FULL_READ_LEN, HAMMER_K, device),
            bayes.expand_chunk_reads(FULL_READ_LEN, HAMMER_K, device),
            correct.vote_chunk_reads(FULL_READ_LEN, HAMMER_K, device))))
    log(f"[kernel] the corrector's shapes (L, k, reads): {hammer_shapes}")
    # the read mapper's (gap closing, repeat resolution): one mate of the
    # full-size library at the last rung's k+1, through the strand entry
    mapper_shapes = ((FULL_READ_LEN, FULL_K + 1, full_reads // 2),)
    strand_shapes = hammer_shapes + mapper_shapes
    rows = []
    for L in (100, 150):
        shapes = [sh for sh in dict.fromkeys(
            SMOKE_SHAPES + main_shapes + strand_shapes) if sh[0] == L]
        most = max(R for _, _, R in shapes)
        codes, lengths = noisy_reads(rng, *sampled_reads(rng, most, L))
        codes_d = torch.from_numpy(codes).to(device)
        lengths_d = torch.from_numpy(lengths).to(device)
        for _, k, R in shapes:
            c, ln = codes_d[:R], lengths_d[:R]
            err = compare_kernel(kernel, c, ln, k)
            n = R * (L - k + 1)
            keys = torch.empty((((k + 15) // 16 + 1) // 2, n),
                               dtype=torch.int64, device=device)
            flags = torch.empty(n, dtype=torch.uint8, device=device) \
                if k % 16 == 0 else None
            ms = cuda_ms(lambda: kernel.launch(c, ln, k, keys, flags), 10)
            strand = (L, k, R) in strand_shapes
            if strand:
                fwd = torch.empty(n, dtype=torch.uint8, device=device)
                strand_ms = cuda_ms(
                    lambda: kernel.launch(c, ln, k, keys, flags, fwd), 10)
                del fwd
            del keys, flags
            wrapper_ms = cuda_ms(lambda: kernel(c, ln, k), 10)
            plain_ms = cuda_ms(lambda: kmer.extract_sort_keys(c, ln, k), 3)
            bound_ms, bound_by, moved = bound_of(R, L, k)
            row = {"L": L, "k": k, "R": R, "windows": n,
                   "bit_equal": err == 0.0, "max_abs_err": err, "ms": ms,
                   "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                   "kernel_bytes": moved, "bound_ms": bound_ms,
                   "bound_by": bound_by,
                   "bound_share": bound_ms / ms,
                   "kernel_GBps": moved / ms / 1e6,
                   "main_path": (L, k, R) in main_shapes + strand_shapes,
                   "hammer": (L, k, R) in hammer_shapes,
                   "mapper": (L, k, R) in mapper_shapes}
            rows.append(row)
            log(f"[kernel] L={L} k={k} R={R} max_abs_err={err} kernel "
                f"{ms:.3f} ms ({row['kernel_GBps']:.0f} GB/s; bound "
                f"{bound_ms:.3f} ms, {row['bound_share']:.0%} of it) "
                f"wrapper {wrapper_ms:.3f} ms plain {plain_ms:.3f} ms")
            if strand:
                s_bound, s_by, s_moved = bound_of(R, L, k, strand=True)
                row.update(strand_ms=strand_ms, strand_bound_ms=s_bound,
                           strand_bytes=s_moved, strand_bound_by=s_by,
                           strand_plain_ms=cuda_ms(
                               lambda: kmer.extract_canonical_keys(
                                   c, ln, k), 3))
                log(f"[kernel] strand entry L={L} k={k} R={R}: "
                    f"{strand_ms:.3f} ms with the strand byte "
                    f"({s_moved / 1e6:.0f} MB, bound {s_bound:.3f} ms, "
                    f"{s_bound / strand_ms:.0%} of it), {ms:.3f} ms without "
                    f"({moved / 1e6:.0f} MB, bound {bound_ms:.3f} ms); plain "
                    f"{row['strand_plain_ms']:.3f} ms")
            if err != 0.0:
                raise AssertionError(f"kernel != plain at L={L} k={k}")
            torch.cuda.empty_cache()
            # the consumer: extraction, sort and run-length encoding of
            # the chunk, and the bytes a window it holds at most
            torch.cuda.reset_peak_memory_stats(device)
            before = torch.cuda.memory_allocated(device)
            row["count_kmers_ms"] = cuda_ms(
                lambda: counter.count_kmers(c, ln, k), 3)
            peak = torch.cuda.max_memory_allocated(device) - before
            row["count_peak_bytes_per_window"] = peak / n
            log(f"[kernel] count_kmers L={L} k={k} R={R}: "
                f"{row['count_kmers_ms']:.3f} ms, peak {peak / n:.1f} bytes "
                f"a window")
            torch.cuda.empty_cache()
    # the edge index's rows: the flat sequence of a graph of the full-size
    # genome (both strands) cut as build_edge_index cuts it
    flat = torch.from_numpy(rng.integers(0, 4, 2 * FULL_GENOME,
                                         dtype=np.uint8)).to(device)
    index_rows = edge_rows_vs_plain(device, flat, 2 * FULL_GENOME,
                                    FULL_K + 1, timed=True)
    del flat
    torch.cuda.empty_cache()
    return {"rows": rows, "ragged": ragged, "index_rows": index_rows}


def edge_rows_vs_plain(device, flat, n: int, k: int, timed: bool) -> dict:
    """The kernel (both entries) against its plain version on the rows
    ``mapping/index.py::build_edge_index`` cuts ``flat[:n]`` into; with
    ``timed`` the strand entry's launch, the wrapper and the plain
    version are timed beside the bound."""
    import torch
    from spades_for_blackbird_tpu_torch.mapping import index
    from spades_for_blackbird_tpu_torch.ops import kmer, kmer_cuda
    kernel = kmer_cuda.extract_sort_keys
    c, ln = index.flat_rows(flat, n, k)
    R, L = c.shape
    err = compare_kernel(kernel, c, ln, k)
    row = {"L": L, "k": k, "R": R, "flat_bases": n,
           "last_row": int(ln[-1]), "max_abs_err": err}
    if timed:
        windows = R * (L - k + 1)
        keys = torch.empty((((k + 15) // 16 + 1) // 2, windows),
                           dtype=torch.int64, device=device)
        flags = torch.empty(windows, dtype=torch.uint8, device=device) \
            if k % 16 == 0 else None
        fwd = torch.empty(windows, dtype=torch.uint8, device=device)
        row["strand_ms"] = cuda_ms(
            lambda: kernel.launch(c, ln, k, keys, flags, fwd), 10)
        del keys, flags, fwd
        row["wrapper_ms"] = cuda_ms(lambda: kernel.canonical_keys(c, ln, k),
                                    10)
        row["plain_ms"] = cuda_ms(
            lambda: kmer.extract_canonical_keys(c, ln, k), 3)
        bound_ms, bound_by, moved = bound_of(R, L, k, strand=True)
        row.update(bound_ms=bound_ms, bound_by=bound_by, kernel_bytes=moved)
        log(f"[kernel] edge index rows L={L} k={k} R={R} (last row "
            f"{row['last_row']} bases): strand entry {row['strand_ms']:.3f} "
            f"ms (bound {bound_ms:.3f} ms, {bound_ms / row['strand_ms']:.0%}"
            f" of it), wrapper {row['wrapper_ms']:.3f} ms, plain "
            f"{row['plain_ms']:.3f} ms")
    log(f"[kernel] edge index rows of {n} bases, L={L} k={k} R={R}: "
        f"max_abs_err={err}")
    if err != 0.0:
        raise AssertionError(f"kernel != plain on edge index rows at k={k}")
    return row


def canonical_contigs(contigs):
    from spades_for_blackbird_tpu_torch.ops import dna
    return sorted((min(s, dna.revcomp_str(s)), c) for s, c in contigs)


def phase_gpu_vs_cpu(device) -> dict:
    from spades_for_blackbird_tpu_torch.pipeline import assemble
    genome, codes, lengths, quals = simulate_reads(20_000, 40.0, 100, seed=5)
    t0 = time.perf_counter()
    gpu = assemble.assemble_single_k(codes, lengths, 21, device=device)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = assemble.assemble_single_k(codes, lengths, 21, device="cpu")
    t_cpu = time.perf_counter() - t0
    a, b = canonical_contigs(gpu.contigs), canonical_contigs(cpu.contigs)
    if [s for s, _ in a] != [s for s, _ in b]:
        raise AssertionError(f"GPU and CPU contigs differ: {len(a)} vs "
                             f"{len(b)} contigs")
    covs_a = np.array([c for _, c in a])
    covs_b = np.array([c for _, c in b])
    if not np.allclose(covs_a, covs_b, rtol=COV_RTOL, atol=0.0):
        raise AssertionError("GPU and CPU contig coverages differ")
    log(f"[gpu-vs-cpu] 20 kb k=21: {len(a)} identical contigs; "
        f"gpu {t_gpu:.2f} s, cpu {t_cpu:.2f} s")
    windows = contig_windows_vs_plain(
        device, [s for s, _ in gpu.contigs], codes.shape[1])
    hammer = hammer_gpu_vs_cpu(device, codes, lengths, quals)
    restricted = restricted_gpu_vs_cpu(device, genome, codes, lengths)
    ladder = cli_gpu_vs_cpu(device, codes, lengths, quals)
    modes = modes_gpu_vs_cpu(device)
    hybrid = hybrid_modes_gpu_vs_cpu(device)
    sums = sums_gpu_vs_cpu(device)
    tools = tools_gpu_vs_cpu(device)
    return {"contigs": len(a), "gpu_s": t_gpu, "cpu_s": t_cpu,
            "contig_windows": windows, "hammer": hammer,
            "restricted": restricted, "cli": ladder, "modes": modes,
            "hybrid_modes": hybrid, "sums": sums, "tools": tools}


def plant_snps(genome: str, lo: int, n: int, spacing: int):
    """A copy of ``genome[lo:lo + n * spacing]`` with a substitution every
    ``spacing`` bases, from ``spacing // 2`` on: (variant, SNP offsets in
    it)."""
    variant = list(genome[lo:lo + n * spacing])
    snps = [spacing // 2 + i * spacing for i in range(n)]
    for p in snps:
        variant[p] = "ACGT"[("ACGT".index(variant[p]) + 1) % 4]
    return "".join(variant), snps


def allele_reads(variant: str, coverage: float, seed: int):
    """Pairs of 100 bp reads of ``variant`` at ``coverage`` (phase 4's
    error rate and insert): (codes (R, L) uint8, lengths (R,) int32)."""
    from spades_for_blackbird_tpu_torch.utils import simulate
    v1, _, v2, _ = simulate.simulate_paired_reads(
        variant, int(coverage * len(variant) / (2 * FULL_READ_LEN)),
        read_len=FULL_READ_LEN, insert_mean=300.0, insert_sd=25.0,
        error_rate=0.002, seed=seed)
    codes = encode_fixed(v1 + v2)
    return codes, np.full(codes.shape[0], FULL_READ_LEN, np.int32)


def windows_kept(contigs, windows) -> int:
    """How many ``windows`` (or their reverse complements) lie inside a
    contig."""
    from spades_for_blackbird_tpu_torch.ops import dna
    return sum(any(w in s or dna.revcomp_str(w) in s for s, _ in contigs)
               for w in windows)


def restricted_gpu_vs_cpu(device, genome, codes, lengths) -> dict:
    """``assemble_single_k(restricted_sequences=...)`` at k=21 on the card
    and on the CPU, with a weak second allele (2 kb with 4 SNPs at half
    the coverage) restricted by the 2k+1 windows centred on its SNPs."""
    from spades_for_blackbird_tpu_torch.pipeline import assemble
    variant, snps = plant_snps(genome, 6000, 4, 500)
    vc, vl = allele_reads(variant, FULL_COVERAGE / 2, seed=55)
    codes = np.concatenate([codes, vc])
    lengths = np.concatenate([lengths, vl])
    windows = [variant[p - 21:p + 22] for p in snps]
    out, walls = {}, {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        res = assemble.assemble_single_k(codes, lengths, 21, device=dev,
                                         restricted_sequences=windows)
        walls[str(dev)] = time.perf_counter() - t0
        out[str(dev)] = canonical_contigs(res.contigs)
    a, b = out[str(device)], out["cpu"]
    if [s for s, _ in a] != [s for s, _ in b] or not np.allclose(
            [c for _, c in a], [c for _, c in b], rtol=COV_RTOL, atol=0.0):
        raise AssertionError("restricted assembly differs between card and "
                             "CPU")
    kept = windows_kept(a, windows)
    log(f"[gpu-vs-cpu] 20 kb k=21 restricted_sequences (4 allele windows): "
        f"{len(a)} identical contigs, {kept} windows kept; card "
        f"{walls[str(device)]:.2f} s, cpu {walls['cpu']:.2f} s")
    if kept != len(windows):
        raise AssertionError(f"{len(windows) - kept} restricted windows lost")
    return {"contigs": len(a), "kept": kept, "gpu_s": walls[str(device)],
            "cpu_s": walls["cpu"]}


def hammer_gpu_vs_cpu(device, codes, lengths, quals) -> dict:
    """``correct_reads`` with qualities on the card and on the CPU."""
    import torch
    from spades_for_blackbird_tpu_torch.hammer import correct
    out, walls = {}, {}
    for dev in (device, torch.device("cpu")):
        t0 = time.perf_counter()
        fixed, stats = correct.correct_reads(
            torch.from_numpy(codes), torch.from_numpy(lengths),
            quals=torch.from_numpy(quals), device=dev)
        out[dev.type] = (fixed.cpu().numpy(), stats)
        walls[dev.type] = time.perf_counter() - t0
    (a, sa), (b, sb) = out["cuda"], out["cpu"]
    if sa != sb or not np.array_equal(a, b):
        raise AssertionError(f"correct_reads differs between card and CPU: "
                             f"{int((a != b).sum())} bases, stats {sa} vs "
                             f"{sb}")
    log(f"[gpu-vs-cpu] 20 kb correct_reads: identical corrected reads, "
        f"stats {sa}; card {walls['cuda']:.2f} s, cpu {walls['cpu']:.2f} s")
    return {"stats": sa, "gpu_s": walls["cuda"], "cpu_s": walls["cpu"]}


def corrected_reads_file(out: str) -> bytes:
    import gzip
    with gzip.open(os.path.join(out, "corrected", "corrected.fastq.gz")) as f:
        return f.read()


def cli_gpu_vs_cpu(device, codes, lengths, quals) -> dict:
    """The command line on the card and on the CPU: the ladder alone,
    the default command (correction, then the ladder) and IonHammer's
    correction alone."""
    from spades_for_blackbird_tpu_torch.io import fastq
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    record = {}
    try:
        plain = os.path.join(tmp, "reads.fastq")
        fastq.write_reads_fastq(plain, codes, lengths)
        with_quals = os.path.join(tmp, "reads_q.fastq")
        write_fastq(with_quals, codes, quals)
        # the first half of the reads are the first mates
        half = codes.shape[0] // 2
        mates = [os.path.join(tmp, f"reads_{m}.fastq") for m in (1, 2)]
        write_fastq(mates[0], codes[:half], quals[:half])
        write_fastq(mates[1], codes[half:], quals[half:])
        pair = ["-1", mates[0], "-2", mates[1]]
        # the GFA-input run reads the graph the paired run wrote on the card
        own_gfa = os.path.join(tmp, "paired", str(device),
                               "assembly_graph_with_scaffolds.gfa")
        runs = (("ladder", ["-s", plain, "-k", "21,33",
                            "--only-assembler"]),
                ("default", ["-s", with_quals, "-k", "21"]),
                ("ion", ["-s", with_quals, "--iontorrent",
                         "--only-error-correction"]),
                ("paired", pair + ["-k", "21"]),
                ("careful", pair + ["-k", "21", "--only-assembler",
                                    "--careful"]),
                ("sc", pair + ["-k", "21", "--only-assembler", "--sc"]),
                ("gfa_input", pair + ["--only-assembler",
                                      "--assembly-graph", own_gfa]))
        with CardAndCpu(device, tmp) as both:
            for name, extra in runs:
                if name != "gfa_input":  # it reads the paired run's GFA
                    both.submit(name, extra)
            compared = [(name, extra) + both.run(name, extra)
                        for name, extra in runs]
        for name, extra, walls, (card, cpu) in compared:
            walls["cuda"] = walls[str(device)]
            if name == "ion":
                if corrected_reads_file(card) != corrected_reads_file(cpu):
                    raise AssertionError("--iontorrent corrected reads "
                                         "differ between card and CPU")
                record[name] = {"gpu_s": walls["cuda"], "cpu_s": walls["cpu"]}
                log(f"[gpu-vs-cpu] 20 kb --iontorrent "
                    f"--only-error-correction: identical corrected reads; "
                    f"card {walls['cuda']:.2f} s, cpu {walls['cpu']:.2f} s")
                continue
            for fasta_name in ("contigs.fasta", "scaffolds.fasta"):
                a, b = (read_fasta(os.path.join(d, fasta_name))
                        for d in (card, cpu))
                if [s for s, _ in a] != [s for s, _ in b]:
                    raise AssertionError(f"CLI {name} {fasta_name} differs "
                                         f"between card and CPU")
                if not np.allclose([c for _, c in a], [c for _, c in b],
                                   rtol=COV_RTOL, atol=1e-6):
                    raise AssertionError(f"CLI {name} {fasta_name} "
                                         f"coverages differ")
            a = read_fasta(os.path.join(card, "contigs.fasta"))
            (sa, la, pa), (sb, lb, pb) = (gfa_records(os.path.join(
                d, "assembly_graph_with_scaffolds.gfa")) for d in (card, cpu))
            if [x[:2] for x in sa] != [x[:2] for x in sb] or la != lb \
                    or pa != pb:
                raise AssertionError(f"CLI {name} GFA segments, links or "
                                     f"paths differ between card and CPU")
            if extra[0] == "-1":
                for same in ("contigs.paths", "scaffolds.paths",
                             "final.lib_data"):
                    texts = [open(os.path.join(d, same)).read()
                             for d in (card, cpu)]
                    if texts[0] != texts[1] or not texts[0]:
                        raise AssertionError(f"CLI {name} {same} differs "
                                             f"between card and CPU")
            if not np.allclose([x[2] for x in sa], [x[2] for x in sb],
                               rtol=COV_RTOL, atol=1e-6):
                raise AssertionError(f"CLI {name} GFA segment coverages "
                                     f"differ")
            record[name] = {"contigs": len(a), "segments": len(sa),
                            "links": len(la), "paths": len(pa),
                            "gpu_s": walls["cuda"], "cpu_s": walls["cpu"]}
            log(f"[gpu-vs-cpu] 20 kb {name} through the CLI "
                f"({' '.join(x for x in extra if x not in mates + [own_gfa])}"
                f"): "
                f"{len(a)} identical contigs, {len(sa)} identical segments, "
                f"{len(la)} identical links, {len(pa)} identical P-lines; "
                f"card {walls['cuda']:.2f} s, cpu {walls['cpu']:.2f} s")
        # the run a card's unordered float sums once flipped
        _, extra, _, (_, cpu) = next(c for c in compared
                                     if c[0] == "careful")
        record["careful"]["card_repeats"] = careful_again(
            device, [os.path.join(tmp, "careful", f"cuda_{i}")
                     for i in range(2, CAREFUL_REPEATS + 1)], cpu, extra)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return record


def contig_windows_vs_plain(device, contigs: list[str], width: int) -> list:
    """The kernel against its plain version on what the ladder's later
    rungs hand it: contigs chopped into read-wide rows, most of them
    full, one ragged tail a contig, short contigs whole, and a row count
    that is no multiple of the tile's reads."""
    import torch
    from spades_for_blackbird_tpu_torch.ops import kmer_cuda
    from spades_for_blackbird_tpu_torch.pipeline import assemble
    rows = []
    for k in (34, 56):
        seqs = [s for s in contigs if len(s) >= k]
        # head pieces of the contigs stand in for short contigs, so that
        # rows between k and width bases long are there whatever was
        # assembled
        seqs += [s[:k + 3 * i] for i, s in enumerate(seqs)
                 if k + 3 * i < width]
        codes, lengths = assemble._windows_from_sequences(seqs, width, k)
        if codes.shape[0] % 4 == 1:  # a row more for the offset view
            codes, lengths = codes[:-1], lengths[:-1]
        c_all = torch.from_numpy(codes).to(device)
        ln_all = torch.from_numpy(lengths).to(device)
        R = codes.shape[0] - 1
        for name, lo in (("aligned", 0), ("offset view", 1)):
            err = compare_kernel(kmer_cuda.extract_sort_keys,
                                 c_all[lo:lo + R],
                                 ln_all[lo:lo + R].contiguous(), k)
            rows.append({"L": width, "k": k, "R": R, "view": name,
                         "ragged_rows": int((lengths[lo:lo + R]
                                             < width).sum()),
                         "max_abs_err": err})
            log(f"[kernel] contig windows L={width} k={k} R={R} "
                f"({rows[-1]['ragged_rows']} ragged rows, {name}): "
                f"max_abs_err={err}")
            if err != 0.0:
                raise AssertionError(
                    f"kernel != plain on contig windows at k={k} ({name})")
    return rows


def read_fasta(path: str) -> list[tuple[str, float]]:
    """(sequence, coverage from the NODE_..._cov_C header) of a FASTA."""
    from spades_for_blackbird_tpu_torch.io import fastq
    names, seqs = fastq.read_sequences(path)
    return [(s, float(n.rsplit("_cov_", 1)[1])) for n, s in zip(names, seqs)]


def gfa_records(path: str):
    """([(segment, sequence, coverage)], [link lines], [path lines]) of a
    GFA file."""
    segs, links, paths = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if parts[0] == "S":
                segs.append((parts[1], parts[2], float(parts[3][5:])))
            elif parts[0] == "L":
                links.append(line)
            elif parts[0] == "P":
                paths.append(line)
    return segs, links, paths


def phase_full(device) -> tuple[dict, tuple]:
    """The full-size assembly; returns its record, and the genome, its
    reads, the reads without their errors and the assembled graph."""
    import torch
    from spades_for_blackbird_tpu_torch.ops import kmer_cuda, seg_sum
    from spades_for_blackbird_tpu_torch.pipeline import assemble
    from spades_for_blackbird_tpu_torch.utils import assess, timetrace

    t0 = time.perf_counter()
    genome, codes, lengths, quals, truth = simulate_reads(
        FULL_GENOME, FULL_COVERAGE, FULL_READ_LEN, seed=7, truth=True)
    sim_s = time.perf_counter() - t0
    log(f"[full] simulated {FULL_GENOME} bp, {codes.shape[0]} reads in "
        f"{sim_s:.1f} s")
    kernel = kmer_cuda.extract_sort_keys
    sums = seg_sum.seg_sum
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    timetrace.enable()
    with record_largest_float_sum() as seen:
        kernel.launches = sums.launches = 0
        t0 = time.perf_counter()
        res = assemble.assemble_single_k(codes, lengths, FULL_K,
                                         device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, seg_launches = kernel.launches, sums.launches
    timetrace.disable()
    peak = torch.cuda.max_memory_allocated(device)
    scopes = scope_seconds(timetrace.events())
    for name, sec in sorted(scopes.items(), key=lambda kv: -kv[1]):
        log(f"[full] scope {name}: {sec:.3f} s")
    report = assess.assess([s for s, _ in res.contigs], genome)
    res_stats = res.stats
    log(f"[full] assemble_single_k k={FULL_K}: {wall:.2f} s, peak device "
        f"memory {peak / 2**30:.2f} GiB, kernel launches {launches}, "
        f"seg_sum launches {seg_launches}")
    log(f"[full] contigs: {json.dumps(report.to_dict())}")
    if launches <= 0 or seg_launches <= 0:
        raise AssertionError("the main path never launched a kernel")
    sums_row = main_path_sums(device, seen)
    if report.genome_fraction < 0.97 or report.misassemblies != 0:
        raise AssertionError(
            f"quality bar missed: genome fraction "
            f"{report.genome_fraction:.4f} (>= 0.97), misassemblies "
            f"{report.misassemblies} (== 0)")
    windows = contig_windows_vs_plain(
        device, [s for s, _ in res.contigs], FULL_READ_LEN)
    g = res.graph
    used = int(torch.where(g.alive, g.seq_start + g.seq_len, 0).max())
    index_rows = edge_rows_vs_plain(device, g.seq_flat, used, FULL_K + 1,
                                    timed=True)
    del res
    return {"genome_size": FULL_GENOME, "reads": int(codes.shape[0]),
            "k": FULL_K, "wall_s": wall, "sim_s": sim_s,
            "peak_bytes": int(peak), "launches": launches,
            "seg_launches": seg_launches, "seg_sum": sums_row,
            "scopes_s": scopes, "stats": res_stats,
            "contig_windows": windows, "index_rows": index_rows,
            "assess": report.to_dict()}, (genome, codes, lengths, quals,
                                          truth, g)


def scope_seconds(events) -> dict[str, float]:
    """Seconds by span name of time-trace events."""
    out: dict[str, float] = {}
    for ev in events:
        out[ev["name"]] = out.get(ev["name"], 0.0) + ev["dur"] / 1e6
    return out


def trace_seconds(path: str) -> dict[str, float]:
    """Seconds by span name of a time trace the command line wrote."""
    with open(path) as f:
        return scope_seconds(json.load(f)["traceEvents"])


def phase_ladder(device) -> dict:
    """The default ladder with default checkpoints on the 1 Mb simulation,
    from a FASTQ file to contigs and graph files, through the command
    line."""
    import torch
    from spades_for_blackbird_tpu_torch import cli, native
    from spades_for_blackbird_tpu_torch.io import fastq, gfa
    from spades_for_blackbird_tpu_torch.ops import kmer_cuda
    from spades_for_blackbird_tpu_torch.pipeline.stages import PipelineContext
    from spades_for_blackbird_tpu_torch.utils import assess

    kernel = kmer_cuda.extract_sort_keys
    genome, codes, lengths, _ = simulate_reads(
        LADDER_GENOME, FULL_COVERAGE, FULL_READ_LEN, seed=7)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        fq = os.path.join(tmp, "reads.fastq")
        t0 = time.perf_counter()
        fastq.write_reads_fastq(fq, codes, lengths)
        write_s = time.perf_counter() - t0
        log(f"[ladder] wrote {codes.shape[0]} reads, "
            f"{os.path.getsize(fq) / 1e9:.2f} GB of FASTQ in {write_s:.1f} s")
        out = os.path.join(tmp, "out")
        argv = ["-s", fq, "-o", out, "--only-assembler", "--trace-time"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        kernel.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel.launches
        peak = torch.cuda.max_memory_allocated(device)
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}")
        reader = "native C++" if native.get_lib() is not None else "Python"
        spans = trace_seconds(os.path.join(out, "spades_time_trace.json"))
        stages = {name: spans.get(f"stage:{name}", 0.0) for name in (
            "read_conversion", "k21", "k33", "k55", "repeat_resolution",
            "contig_output")}
        log(f"[ladder] cli.main {' '.join(argv[2:])}: {wall:.2f} s, peak "
            f"device memory {peak / 2**30:.2f} GiB, kernel launches "
            f"{launches}, reads parsed by the {reader} reader")
        for name, sec in stages.items():
            log(f"[ladder] stage {name}: {sec:.3f} s")
        # what --checkpoints none would leave: the wall less the stage
        # saves (the pre-simplify saves inside the rungs stay)
        less_saves = wall - spans.get("checkpoint_save", 0.0)
        log(f"[ladder] wall less the checkpoint_save spans: "
            f"{less_saves:.2f} s")
        for name in ("count_kmers", "count_extra_contigs",
                     "coverage_model_fit", "vertex_table", "early_tips",
                     "condense", "phase_checkpoint", "simplify",
                     "graph_contigs", "checkpoint_save"):
            log(f"[ladder] scope {name} (all rungs): "
                f"{spans.get(name, 0.0):.3f} s")
        with open(os.path.join(out, "spades.log")) as f:
            text = f.read()
        for line in text.splitlines():
            if "done in" in line or "K=" in line:
                log(f"[ladder] log: {line}")

        contigs = read_fasta(os.path.join(out, "contigs.fasta"))
        report = assess.assess([s for s, _ in contigs], genome)
        log(f"[ladder] contigs: {json.dumps(report.to_dict())}")
        log(f"[ladder] {LADDER_GENOME} bp, ladder 21,33,55: "
            f"{report.n_contigs} contigs, NG50 {report.ng50}")
        if report.genome_fraction < 0.97 or report.misassemblies != 0:
            raise AssertionError(
                f"quality bar missed: genome fraction "
                f"{report.genome_fraction:.4f} (>= 0.97), misassemblies "
                f"{report.misassemblies} (== 0)")
        if launches < 5:
            raise AssertionError(
                f"the ladder launched the kernel {launches} times; 3 rungs "
                f"on the reads and 2 on contig windows need 5")
        segments, links = gfa.read_gfa(
            os.path.join(out, "assembly_graph_with_scaffolds.gfa"))
        graph = PipelineContext.load(
            os.path.join(out, "saves", "contig_output")).graph
        pairs = len(gfa.segment_naming(graph)[0])
        log(f"[ladder] GFA reads back: {len(segments)} segments, "
            f"{len(links)} links; the graph has {pairs} live edge pairs")
        if len(segments) != pairs or not pairs:
            raise AssertionError("the GFA's segments are not the graph's "
                                 "live edge pairs")
        for name in ("before_rr.fasta", "scaffolds.fasta",
                     "assembly_graph.fastg", "params.json"):
            if not os.path.getsize(os.path.join(out, name)):
                raise AssertionError(f"{name} is empty")

        t0 = time.perf_counter()
        rc = cli.main(argv + ["--continue"])
        continue_s = time.perf_counter() - t0
        with open(os.path.join(out, "spades.log")) as f:
            text = f.read()
        redone = text.count("== STAGE k55\n") - 1
        if rc != 0 or redone or "all stages already complete" not in text:
            raise AssertionError(
                f"--continue on a finished run returned {rc} and ran k55 "
                f"{redone} more time(s)")
        log(f"[ladder] --continue on the finished run: rc 0, no stage "
            f"redone, {continue_s:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"genome_size": LADDER_GENOME, "reads": int(codes.shape[0]),
            "wall_s": wall, "fastq_write_s": write_s, "reader": reader,
            "peak_bytes": int(peak), "launches": launches,
            "stages_s": stages, "spans_s": spans,
            "checkpoint_save_s": spans.get("checkpoint_save", 0.0),
            "wall_less_saves_s": less_saves, "continue_s": continue_s,
            "segments": len(segments), "links": len(links),
            "assess": report.to_dict()}


@contextlib.contextmanager
def plain_extraction_refused():
    """While open, the plain versions of the kernels (the k-mer
    extraction functions, the banded edit distance and the Viterbi)
    raise when handed a tensor on the card: the main path must take the
    kernels there."""
    from spades_for_blackbird_tpu_torch.ops import align, hmm, kmer
    guards = [(kmer, name) for name in (
        "extract_kmers", "extract_canonical_kmers", "extract_sort_keys",
        "extract_canonical_keys")]
    guards += [(align, "banded_edit_distance_plain"),
               (hmm, "viterbi_ends_plain"), (hmm, "viterbi_batched_plain")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in guards]

    def guarded(name, fn):
        def call(first, *args, **kwargs):
            rows = {"viterbi_ends_plain": lambda: args[7],
                    "viterbi_batched_plain": lambda: args[0]}.get(
                name, lambda: first)()
            if rows.is_cuda:
                raise AssertionError(f"plain {name} was called with a "
                                     f"tensor on the card")
            return fn(first, *args, **kwargs)
        return call
    for mod, name, fn in saved:
        setattr(mod, name, guarded(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_hammer(device, genome, codes, lengths, quals, truth) -> dict:
    """The error corrector on the 4.6 Mb simulation: ``correct_reads`` on
    the card against the true reads, then the default command."""
    import torch
    from spades_for_blackbird_tpu_torch import cli
    from spades_for_blackbird_tpu_torch.hammer import correct
    from spades_for_blackbird_tpu_torch.ops import kmer_cuda
    from spades_for_blackbird_tpu_torch.utils import assess, timetrace

    kernel = kmer_cuda.extract_sort_keys
    wrong = codes != truth
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with plain_extraction_refused():
            # (a) correct_reads on the card
            c = torch.from_numpy(codes).to(device)
            ln = torch.from_numpy(lengths).to(device)
            q = torch.from_numpy(quals).to(device)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            before_mem = torch.cuda.memory_allocated(device)
            timetrace.enable()
            kernel.launches = 0
            t0 = time.perf_counter()
            fixed, stats = correct.correct_reads(c, ln, quals=q,
                                                 device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernel.launches
            timetrace.disable()
            peak = torch.cuda.max_memory_allocated(device) - before_mem
            scopes = scope_seconds(timetrace.events())
            fixed = fixed.cpu().numpy()
            del c, ln, q
            torch.cuda.empty_cache()
            after = fixed != truth
            counts = {"wrong_before": int(wrong.sum()),
                      "wrong_after": int(after.sum()),
                      "made_wrong": int((after & ~wrong).sum()),
                      "fixed": int((wrong & ~after).sum())}
            log(f"[hammer] correct_reads on {codes.shape[0]} reads: "
                f"{wall:.2f} s, peak device memory {peak / 2**30:.2f} GiB "
                f"above the reads, kernel launches {launches}, stats {stats}")
            for name in HAMMER_SCOPES:
                log(f"[hammer] scope {name} (both iterations): "
                    f"{scopes.get(name, 0.0):.3f} s")
            log(f"[hammer] bases wrong before {counts['wrong_before']}, "
                f"after {counts['wrong_after']} "
                f"({counts['wrong_after'] / max(counts['wrong_before'], 1):.1%}"
                f" left), fixed {counts['fixed']}, made wrong "
                f"{counts['made_wrong']}")
            if launches <= 0:
                raise AssertionError("the corrector never launched the "
                                     "kernel")
            if counts["wrong_after"] * 4 > counts["wrong_before"]:
                raise AssertionError("more than a quarter of the wrong "
                                     "bases are left")

            # (b) the default command on the reads with their qualities
            fq = os.path.join(tmp, "reads.fastq")
            t0 = time.perf_counter()
            write_fastq(fq, codes, quals)
            write_s = time.perf_counter() - t0
            out = os.path.join(tmp, "out")
            argv = ["-s", fq, "-o", out, "--checkpoints", "none",
                    "-k", str(FULL_K), "--trace-time"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            kernel.launches = 0
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            cli_wall = time.perf_counter() - t0
            cli_launches = kernel.launches
            cli_peak = torch.cuda.max_memory_allocated(device)
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}")
        spans = trace_seconds(os.path.join(out, "spades_time_trace.json"))
        stages = {name: spans.get(f"stage:{name}", 0.0) for name in (
            "read_conversion", "error_correction", "k21", "k33", "k55",
            "repeat_resolution", "contig_output")}
        log(f"[hammer] wrote {os.path.getsize(fq) / 1e9:.2f} GB of FASTQ "
            f"with qualities in {write_s:.1f} s")
        log(f"[hammer] cli.main {' '.join(argv[2:])}: {cli_wall:.2f} s, peak "
            f"device memory {cli_peak / 2**30:.2f} GiB, kernel launches "
            f"{cli_launches}")
        for name, sec in stages.items():
            log(f"[hammer] stage {name}: {sec:.3f} s")
        for name in HAMMER_SCOPES:
            log(f"[hammer] cli scope {name}: {spans.get(name, 0.0):.3f} s")
        with open(os.path.join(out, "spades.log")) as f:
            logged = [ln.split("correction: ", 1)[1] for ln in f
                      if "correction: {" in ln]
        cli_stats = ast.literal_eval(logged[-1]) if logged else None
        log(f"[hammer] the command line's correction stats: {cli_stats}")
        if cli_stats != stats:
            raise AssertionError(f"the default command corrected otherwise: "
                                 f"{cli_stats} vs {stats}")
        contigs = read_fasta(os.path.join(out, "contigs.fasta"))
        report = assess.assess([s for s, _ in contigs], genome)
        log(f"[hammer] contigs: {json.dumps(report.to_dict())}")
        if report.genome_fraction < 0.97 or report.misassemblies != 0:
            raise AssertionError(
                f"quality bar missed: genome fraction "
                f"{report.genome_fraction:.4f} (>= 0.97), misassemblies "
                f"{report.misassemblies} (== 0)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"reads": int(codes.shape[0]), "wall_s": wall, "stats": stats,
            "launches": launches, "peak_bytes": int(peak),
            "scopes_s": scopes, **counts,
            "fastq_write_s": write_s,
            "cli_wall_s": cli_wall, "cli_launches": cli_launches,
            "cli_peak_bytes": int(cli_peak), "cli_stages_s": stages,
            "cli_spans_s": spans, "assess": report.to_dict()}


@contextlib.contextmanager
def launches_inside(kernel, targets):
    """While open, count the kernel's launches made inside each of the
    functions ``targets`` names ((module, attribute) pairs; the stages
    call them through their module): yields {attribute: launches}."""
    counts = {name: 0 for _, name in targets}
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def counted(name, fn):
        def call(*args, **kwargs):
            before = kernel.launches
            try:
                return fn(*args, **kwargs)
            finally:
                counts[name] += kernel.launches - before
        return call
    for mod, name, fn in saved:
        setattr(mod, name, counted(name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def assess_fasta(fasta_path: str, genome: str, strip_n: bool = False):
    """``utils/assess`` of a FASTA against the truth (scaffolds with their
    N's removed, as scale_bench.py grades them)."""
    from spades_for_blackbird_tpu_torch.utils import assess
    seqs = [s.replace("N", "") if strip_n else s
            for s, _ in read_fasta(fasta_path)]
    return assess.assess(seqs, genome)


def quality(fasta_path: str, genome: str, strip_n: bool = False):
    """``assess_fasta``; raises below the bar."""
    report = assess_fasta(fasta_path, genome, strip_n)
    if report.genome_fraction < 0.97 or report.misassemblies != 0:
        raise AssertionError(
            f"quality bar missed on {os.path.basename(fasta_path)}: genome "
            f"fraction {report.genome_fraction:.4f} (>= 0.97), "
            f"misassemblies {report.misassemblies} (== 0)")
    return report


def phase_paired(device, genome, codes, lengths, quals, tmp) -> dict:
    """The paired default command on the 4.6 Mb simulation: correction,
    the ladder, gap closing and paired repeat resolution, from two FASTQ
    files to contigs and scaffolds. The mates and the profiled run's
    output stay in ``tmp`` for phases 9 and 11."""
    import torch
    from spades_for_blackbird_tpu_torch import cli
    from spades_for_blackbird_tpu_torch.ops import kmer_cuda, seg_sum
    from spades_for_blackbird_tpu_torch.pipeline import assemble, gap_closer

    kernel = kmer_cuda.extract_sort_keys
    half = codes.shape[0] // 2  # the first half are the first mates
    mates = [os.path.join(tmp, f"reads_{m}.fastq") for m in (1, 2)]
    t0 = time.perf_counter()
    write_fastq(mates[0], codes[:half], quals[:half])
    write_fastq(mates[1], codes[half:], quals[half:])
    write_s = time.perf_counter() - t0
    log(f"[paired] wrote 2 x {half} reads with qualities, "
        f"{sum(os.path.getsize(m) for m in mates) / 1e9:.2f} GB of "
        f"FASTQ in {write_s:.1f} s")
    argv = ["-1", mates[0], "-2", mates[1], "--checkpoints", "none",
            "--trace-time"]
    out = os.path.join(tmp, "out")
    with plain_extraction_refused(), launches_inside(
            kernel, [(gap_closer, "close_gaps"),
                     (assemble, "repeat_resolution_multi")]) as inside:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        kernel.launches = seg_sum.seg_sum.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(argv + ["-o", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, seg_launches = kernel.launches, seg_sum.seg_sum.launches
        peak = torch.cuda.max_memory_allocated(device)
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    spans = trace_seconds(os.path.join(out, "spades_time_trace.json"))
    stages = {name: spans.get(f"stage:{name}", 0.0) for name in (
        "read_conversion", "error_correction", "k21", "k33", "k55",
        "gap_closing", "repeat_resolution", "contig_output")}
    log(f"[paired] cli.main -1 -2 {' '.join(argv[4:])}: {wall:.2f} s, "
        f"peak device memory {peak / 2**30:.2f} GiB, kernel launches "
        f"{launches} (gap closing {inside['close_gaps']}, repeat "
        f"resolution {inside['repeat_resolution_multi']})")
    for name, sec in stages.items():
        log(f"[paired] stage {name}: {sec:.3f} s")
    for name in RR_SCOPES + ("coverage_model_fit", "condense",
                             "simplify", "phase_checkpoint"):
        log(f"[paired] scope {name}: {spans.get(name, 0.0):.3f} s")
    with open(os.path.join(out, "final.lib_data")) as f:
        lib_data = f.read()
    log("[paired] final.lib_data: " + " ".join(lib_data.split()))
    with open(os.path.join(out, "spades.log")) as f:
        for line in f:
            if "closed" in line or "resolved" in line or "lib 0" in line:
                log(f"[paired] log: {line.strip()}")
    reports = {}
    for name, strip_n in (("contigs", False), ("scaffolds", True)):
        rep = quality(os.path.join(out, f"{name}.fasta"), genome, strip_n)
        reports[name] = rep.to_dict()
        log(f"[paired] {name}: {rep.n_contigs} sequences, NG50 "
            f"{rep.ng50} (the JAX package's record of this simulation: "
            f"{JAX_NG50[name]}), genome fraction "
            f"{rep.genome_fraction:.5f}, misassemblies "
            f"{rep.misassemblies}")
    for name, n in dict(inside, seg_sum=seg_launches).items():
        if n <= 0:
            raise AssertionError(f"{name} never launched its kernel")
    log(f"[paired] seg_sum launches {seg_launches}")
    for name in ("contigs.paths", "scaffolds.paths",
                 "scaffold_graph.scg", "assembly_graph.fastg"):
        if not os.path.getsize(os.path.join(out, name)):
            raise AssertionError(f"{name} is empty")
    if not gfa_records(os.path.join(
            out, "assembly_graph_with_scaffolds.gfa"))[2]:
        raise AssertionError("the GFA holds no scaffold P-line")

    return {"reads": int(codes.shape[0]), "wall_s": wall,
            "mates": mates, "out": out,
            "fastq_write_s": write_s, "launches": launches,
            "seg_launches": seg_launches,
            "launches_inside": dict(inside), "peak_bytes": int(peak),
            "stages_s": stages, "spans_s": spans, "lib_data": lib_data,
            "assess": reports}


def stage_seconds(out: str, names) -> dict[str, float]:
    """Seconds of the named stages in the time trace of a CLI run."""
    spans = trace_seconds(os.path.join(out, "spades_time_trace.json"))
    return {name: spans.get(f"stage:{name}", 0.0) for name in names}, spans


def run_cli(device, argv, kernel, targets=()):
    """``cli.main(argv)`` with the launch count at 0 before it: (wall s,
    launches, launches inside each of ``targets``, peak device bytes);
    raises unless it returns 0."""
    import torch
    from spades_for_blackbird_tpu_torch import cli
    with launches_inside(kernel, targets) as inside:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        kernel.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel.launches
    if rc != 0:
        raise AssertionError(f"cli.main {' '.join(argv)} returned {rc}")
    return wall, launches, dict(inside), torch.cuda.max_memory_allocated(
        device)


def plant_errors(g, n: int, seed: int):
    """``g`` with ``n`` bases changed in edges longer than 1 kb, each at
    least 200 bases from the edge's ends and 500 from the one before,
    mirrored on the conjugate edge (two flat slots an error). Returns
    (graph, planted slots (2n,) int64 tensor)."""
    import torch
    rng = np.random.default_rng(seed)
    alive = g.alive.cpu().numpy() & (np.arange(g.capacity)
                                     < int(g.num_edges))
    start, length = g.seq_start.cpu().numpy(), g.seq_len.cpu().numpy()
    conj = g.conj.cpu().numpy()
    flat = g.seq_flat.cpu().numpy().copy()
    slots = []
    for e in np.nonzero(alive & (length > 1000))[0]:
        if conj[e] <= e or len(slots) == 2 * n:
            continue
        for p in range(200 + int(rng.integers(0, 300)),
                       int(length[e]) - 200, 500):
            if len(slots) == 2 * n:
                break
            s, cs = int(start[e]) + p, int(start[conj[e]]) + \
                int(length[e]) - 1 - p
            flat[s] = (flat[s] + int(rng.integers(1, 4))) % 4
            flat[cs] = 3 - flat[s]
            slots += [s, cs]
    if len(slots) != 2 * n:
        raise AssertionError(f"room for {len(slots) // 2} planted errors, "
                             f"not {n}")
    return (g._replace(seq_flat=torch.from_numpy(flat).to(g.device)),
            torch.tensor(slots, device=g.device))


def phase_careful(device, genome, graph, codes, lengths, mates, tmp) -> dict:
    """Careful mode at full size: (a) ``correct_mismatches`` on phase 4's
    k=55 graph with planted errors, using phase 4's reads; (b) the paired
    default command of phase 8 with ``--careful``."""
    import torch
    from spades_for_blackbird_tpu_torch.ops import kmer_cuda
    from spades_for_blackbird_tpu_torch.pipeline import mismatch_correction
    from spades_for_blackbird_tpu_torch.utils import timetrace

    kernel = kmer_cuda.extract_sort_keys
    bad, slots = plant_errors(graph, CAREFUL_ERRORS, seed=9)
    with plain_extraction_refused():
        c = torch.from_numpy(codes).to(device)
        ln = torch.from_numpy(lengths).to(device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        before_mem = torch.cuda.memory_allocated(device)
        timetrace.enable()
        kernel.launches = 0
        t0 = time.perf_counter()
        fixed, n = mismatch_correction.correct_mismatches(bad, c, ln,
                                                          device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel.launches
        timetrace.disable()
        peak = torch.cuda.max_memory_allocated(device) - before_mem
        scopes = scope_seconds(timetrace.events())
        del c, ln
        changed = fixed.seq_flat != graph.seq_flat
        unfixed = int(changed[slots].sum())
        changed[slots] = False
        others = int(changed.sum())
        log(f"[careful] correct_mismatches on the k={FULL_K} graph "
            f"({int(graph.seq_flat.shape[0])} flat bases) with "
            f"{CAREFUL_ERRORS} planted errors ({slots.numel()} slots), "
            f"{codes.shape[0]} reads: {wall:.3f} s, {n} bases changed, "
            f"planted slots left wrong {unfixed}, other bases changed "
            f"{others}, kernel launches {launches}, peak device memory "
            f"{peak / 2**30:.2f} GiB above the reads")
        for name in ("mc_build_index", "mc_map_vote", "mc_fix"):
            log(f"[careful] scope {name}: {scopes.get(name, 0.0):.3f} s")
        if unfixed:
            raise AssertionError(f"{unfixed} planted slots left wrong")
        if launches < 2:
            raise AssertionError("correct_mismatches launched the kernel "
                                 f"{launches} times")
        del fixed, bad, changed
        torch.cuda.empty_cache()

        # (b) the paired default command with --careful
        out = os.path.join(tmp, "careful")
        argv = ["-1", mates[0], "-2", mates[1], "--careful", "-k",
                str(FULL_K), "--checkpoints", "none", "--trace-time", "-o",
                out]
        cli_wall, cli_launches, inside, cli_peak = run_cli(
            device, argv, kernel,
            [(mismatch_correction, "correct_mismatches")])
    stages, spans = stage_seconds(out, (
        "read_conversion", "error_correction", "k21", "k33", "k55",
        "gap_closing", "mismatch_correction", "repeat_resolution",
        "contig_output"))
    with open(os.path.join(out, "spades.log")) as f:
        corrected = [int(line.split("corrected ")[1].split()[0])
                     for line in f if "mismatching bases" in line]
    log(f"[careful] cli.main -1 -2 --careful: {cli_wall:.2f} s, peak device "
        f"memory {cli_peak / 2**30:.2f} GiB, kernel launches {cli_launches} "
        f"({inside['correct_mismatches']} inside correct_mismatches), "
        f"corrected bases {corrected}")
    for name, sec in stages.items():
        log(f"[careful] stage {name}: {sec:.3f} s")
    for name in ("mc_build_index", "mc_map_vote", "mc_fix"):
        log(f"[careful] cli scope {name}: {spans.get(name, 0.0):.3f} s")
    if inside["correct_mismatches"] < 2:
        raise AssertionError("the careful stage launched the kernel "
                             f"{inside['correct_mismatches']} times")
    reports = {}
    for name, strip_n in (("contigs", False), ("scaffolds", True)):
        rep = quality(os.path.join(out, f"{name}.fasta"), genome, strip_n)
        reports[name] = rep.to_dict()
        log(f"[careful] {name}: {rep.n_contigs} sequences, NG50 {rep.ng50}, "
            f"genome fraction {rep.genome_fraction:.5f}, misassemblies "
            f"{rep.misassemblies}")
    return {"planted": CAREFUL_ERRORS, "wall_s": wall, "changed": n,
            "unfixed": unfixed, "others_changed": others,
            "launches": launches, "peak_bytes": int(peak),
            "scopes_s": scopes, "cli_wall_s": cli_wall,
            "cli_launches": cli_launches,
            "cli_launches_inside": inside["correct_mismatches"],
            "cli_peak_bytes": int(cli_peak), "cli_stages_s": stages,
            "corrected": corrected, "assess": reports}


def simulate_uneven(genome: str, seed: int):
    """MDA-like reads of ``genome``: coverage constant over blocks of
    ``SC_BLOCK`` bases, ``clip(40 * exp(0.8 z), 8, 200)`` a block with z
    standard normal; phase 8's read length, error rate and FR insert
    (300 +- 25), qualities as ``utils/simulate.py`` gives them. Returns
    (block coverages, first mates, second mates), each mate set as
    (codes (R, L) uint8, quals (R, L) uint8 phred+33)."""
    from spades_for_blackbird_tpu_torch.ops import dna
    rng = np.random.default_rng(seed)
    g = dna.encode_str(genome)
    L, rl = len(g), FULL_READ_LEN
    n_blocks = -(-L // SC_BLOCK)
    cov = np.clip(40.0 * np.exp(0.8 * rng.standard_normal(n_blocks)), 8.0,
                  200.0)
    sizes = np.minimum(SC_BLOCK, L - SC_BLOCK * np.arange(n_blocks))
    weight = cov * sizes
    n_pairs = int(weight.sum() / (2 * rl))
    block = rng.choice(n_blocks, n_pairs, p=weight / weight.sum())
    ins = np.clip(rng.normal(300.0, 25.0, n_pairs).astype(np.int64), rl,
                  None)
    start = np.minimum(block * SC_BLOCK + rng.integers(0, sizes[block]),
                       L - ins)
    offs = np.arange(rl)
    r1 = g[start[:, None] + offs]
    r2 = 3 - g[(start + ins - rl)[:, None] + offs][:, ::-1]
    flip = rng.random(n_pairs) < 0.5   # fragments on the reverse strand
    r1, r2 = (np.where(flip[:, None], 3 - r2[:, ::-1], r1),
              np.where(flip[:, None], 3 - r1[:, ::-1], r2))
    return cov, with_errors(rng, r1), with_errors(rng, r2)


def phase_sc(device, genome, tmp) -> dict:
    """Single-cell mode at full size on uneven coverage: the ``--sc``
    command line from two FASTQ files, then ``assemble_single_k(...,
    uneven_depth=True)`` at k=21 and k=55 on the same reads."""
    import torch
    from spades_for_blackbird_tpu_torch.kmers import counter, coverage_model
    from spades_for_blackbird_tpu_torch.ops import kmer_cuda
    from spades_for_blackbird_tpu_torch.pipeline import assemble
    from spades_for_blackbird_tpu_torch.utils import timetrace

    kernel = kmer_cuda.extract_sort_keys
    t0 = time.perf_counter()
    cov, (c1, q1), (c2, q2) = simulate_uneven(genome, seed=8)
    mates = [os.path.join(tmp, f"sc_{m}.fastq") for m in (1, 2)]
    write_fastq(mates[0], c1, q1)
    write_fastq(mates[1], c2, q2)
    log(f"[sc] {len(cov)} blocks of {SC_BLOCK} bases at coverage "
        f"{cov.min():.1f}-{cov.max():.1f} (median {np.median(cov):.1f}, "
        f"mean {cov.mean():.1f}): 2 x {c1.shape[0]} reads simulated and "
        f"written in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(tmp, "sc")
    argv = ["-1", mates[0], "-2", mates[1], "-o", out, "--sc",
            "--checkpoints", "none", "--trace-time"]
    with plain_extraction_refused():
        wall, launches, _, peak = run_cli(device, argv, kernel)
    stages, spans = stage_seconds(out, (
        "read_conversion", "error_correction", "k21", "k33", "k55",
        "gap_closing", "repeat_resolution", "contig_output"))
    log(f"[sc] cli.main -1 -2 --sc: {wall:.2f} s, peak device memory "
        f"{peak / 2**30:.2f} GiB, kernel launches {launches}")
    for name, sec in stages.items():
        log(f"[sc] stage {name}: {sec:.3f} s")
    for name in SC_SCOPES + ("simplify", "coverage_model_fit", "condense"):
        log(f"[sc] scope {name} (all rungs): {spans.get(name, 0.0):.3f} s")
    reports = {}
    for name, strip_n in (("contigs", False), ("scaffolds", True)):
        rep = assess_fasta(os.path.join(out, f"{name}.fasta"), genome,
                           strip_n)
        reports[name] = rep.to_dict()
        log(f"[sc] {name}: {rep.n_contigs} sequences, NG50 {rep.ng50}, "
            f"genome fraction {rep.genome_fraction:.5f}, misassemblies "
            f"{rep.misassemblies}")
    if reports["contigs"]["misassemblies"] != 0 or \
            reports["contigs"]["genome_fraction"] < SC_FRACTION:
        raise AssertionError(f"--sc missed its bar on contigs: "
                             f"{reports['contigs']}")

    codes = np.concatenate([c1, c2])
    lengths = np.full(codes.shape[0], FULL_READ_LEN, np.int32)
    uneven = {}
    with plain_extraction_refused():
        for k in (FULL_K,):
            timetrace.enable()
            kernel.launches = 0
            t0 = time.perf_counter()
            res = assemble.assemble_single_k(codes, lengths, k,
                                             uneven_depth=True,
                                             device=device)
            torch.cuda.synchronize()
            k_wall = time.perf_counter() - t0
            timetrace.disable()
            sc = scope_seconds(timetrace.events())
            uneven[k] = {"uneven_ec_bound": res.genomic_info.ec_bound,
                         "fit_ec_bound": None, "wall_s": k_wall,
                         "launches": kernel.launches,
                         "uneven_ec_bound_s": sc.get("uneven_ec_bound", 0.0),
                         "coverage_model_fit_s": sc.get("coverage_model_fit",
                                                        0.0),
                         "stats": res.stats}
            del res
        # the spectrum fit's bound on the same reads, for comparison
        c = torch.from_numpy(codes).to(device)
        ln = torch.from_numpy(lengths).to(device)
        for k in (FULL_K,):
            kp1 = counter.trim_table(counter.count_kmers_chunked(c, ln,
                                                                 k + 1))
            uneven[k]["fit_ec_bound"] = \
                coverage_model.fit_coverage_model_hist(
                    coverage_model.count_spectrum_device(
                        kp1.counts, kp1.num)).ec_bound
            del kp1
            log(f"[sc] assemble_single_k k={k} uneven_depth=True: "
                f"{uneven[k]['wall_s']:.2f} s, {uneven[k]['launches']} "
                f"launches; uneven_ec_bound {uneven[k]['uneven_ec_bound']:.4f}"
                f" in {uneven[k]['uneven_ec_bound_s']:.3f} s (scope "
                f"uneven_ec_bound), the spectrum fit's ec_bound "
                f"{uneven[k]['fit_ec_bound']:.4f}; {uneven[k]['stats']}")
        del c, ln
    return {"blocks": len(cov), "block_cov_min": float(cov.min()),
            "block_cov_max": float(cov.max()),
            "block_cov_mean": float(cov.mean()), "reads": 2 * c1.shape[0],
            "wall_s": wall, "launches": launches, "peak_bytes": int(peak),
            "stages_s": stages, "spans_s": spans, "assess": reports,
            "uneven": uneven}


def phase_fork(device, genome, codes, lengths, mates, gfa_path, tmp) -> dict:
    """The fork's paths at full size: (a) ``assemble_single_k`` at k=55
    on phase 4's reads plus a second allele of 20 kb (40 SNPs 500 bases
    apart, at the main copy's coverage), without and with the 2k+1 = 111
    base windows centred on its SNPs as restricted sequences; (b) the
    paired reads of phase 8 with ``--only-assembler --assembly-graph`` on
    phase 8's GFA."""
    import torch
    from spades_for_blackbird_tpu_torch.io import fasta
    from spades_for_blackbird_tpu_torch.ops import kmer_cuda
    from spades_for_blackbird_tpu_torch.pipeline import assemble, gap_closer
    from spades_for_blackbird_tpu_torch.simplify import runner

    kernel = kmer_cuda.extract_sort_keys
    variant, snps = plant_snps(genome, VARIANT_AT, VARIANT_SNPS, 500)
    windows = [variant[p - FULL_K:p + FULL_K + 1] for p in snps]
    runs = {}
    with plain_extraction_refused(), launches_inside(
            kernel, [(runner, "simplify_graph")]) as inside:
        for name, cov, restricted in (
                ("free", VARIANT_COVERAGE, None),
                ("restricted", VARIANT_COVERAGE, windows)):
            vc, vl = allele_reads(variant, cov, seed=10)
            all_codes = np.concatenate([codes, vc])
            all_lengths = np.concatenate([lengths, vl])
            torch.cuda.synchronize()
            kernel.launches = 0
            inside["simplify_graph"] = 0
            t0 = time.perf_counter()
            res = assemble.assemble_single_k(
                all_codes, all_lengths, FULL_K, device=device,
                restricted_sequences=restricted)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            edges = fasta.graph_contigs(res.graph, min_length=FULL_K + 1)
            runs[name] = {"wall_s": wall, "allele_coverage": cov,
                          "allele_reads": int(len(vc)),
                          "launches": kernel.launches,
                          "launches_in_simplify": inside["simplify_graph"],
                          "kept": windows_kept(edges, windows),
                          "ec_bound": res.genomic_info.ec_bound,
                          "stats": res.stats}
            del res, edges
            log(f"[fork] assemble_single_k k={FULL_K}, {len(all_codes)} "
                f"reads ({len(vc)} of the allele at {cov:g}x), {name}: "
                f"{wall:.2f} s, kernel launches {runs[name]['launches']} "
                f"({runs[name]['launches_in_simplify']} inside simplify), "
                f"ec_bound {runs[name]['ec_bound']:.3f}, allele windows "
                f"kept {runs[name]['kept']} of {len(windows)}")
    if runs["restricted"]["kept"] != len(windows):
        raise AssertionError(f"{len(windows) - runs['restricted']['kept']} "
                             f"restricted windows lost")

    # (b) GFA input: phase 8's graph and its reads
    out = os.path.join(tmp, "gfa_input")
    argv = ["-1", mates[0], "-2", mates[1], "--only-assembler",
            "--assembly-graph", gfa_path, "-o", out, "--checkpoints", "none",
            "--trace-time"]
    with plain_extraction_refused():
        wall, launches, inside, peak = run_cli(
            device, argv, kernel, [(gap_closer, "close_gaps"),
                                   (assemble, "repeat_resolution_multi")])
    stages, _ = stage_seconds(out, ("read_conversion", "load_graph",
                                    "gap_closing", "repeat_resolution",
                                    "contig_output"))
    log(f"[fork] cli.main -1 -2 --only-assembler --assembly-graph: "
        f"{wall:.2f} s, peak device memory {peak / 2**30:.2f} GiB, kernel "
        f"launches {launches} {inside}")
    for name, sec in stages.items():
        log(f"[fork] stage {name}: {sec:.3f} s")
    reports = {}
    for name, strip_n in (("contigs", False), ("scaffolds", True)):
        rep = quality(os.path.join(out, f"{name}.fasta"), genome, strip_n)
        reports[name] = rep.to_dict()
        log(f"[fork] --assembly-graph {name}: {rep.n_contigs} sequences, "
            f"NG50 {rep.ng50}, genome fraction {rep.genome_fraction:.5f}, "
            f"misassemblies {rep.misassemblies}")
    return {"windows": len(windows), "runs": runs,
            "gfa_wall_s": wall, "gfa_launches": launches,
            "gfa_launches_inside": inside, "gfa_peak_bytes": int(peak),
            "gfa_stages_s": stages, "gfa_assess": reports}


# ---------------------------------------------------------------------
# The metagenomic, plasmid and RNA modes (phases 3, 12-14)
# ---------------------------------------------------------------------

def sample_pairs(rng, g, n_pairs: int, circular: bool = False,
                 stranded: bool = False, insert_mean: float = 300.0,
                 insert_sd: float = 25.0):
    """FR pairs of FULL_READ_LEN bases from the codes ``g`` (uint8, 0..3):
    fragments of N(insert_mean, insert_sd) bases, on either strand unless
    ``stranded`` (then the first mate reads ``g``'s strand); on a circle
    the fragments start anywhere and wrap. Error-free (r1, r2) uint8."""
    rl = FULL_READ_LEN
    L = len(g)
    ins = np.clip(rng.normal(insert_mean, insert_sd, n_pairs).astype(
        np.int64), rl, None)
    if circular:
        start = rng.integers(0, L, n_pairs)
        src = np.concatenate([g, g[:int(ins.max(initial=rl))]])
    else:
        ins = np.minimum(ins, L)
        start = (rng.random(n_pairs) * (L - ins + 1)).astype(np.int64)
        src = g
    offs = np.arange(rl)
    r1 = src[start[:, None] + offs]
    r2 = 3 - src[(start + ins - rl)[:, None] + offs][:, ::-1]
    if not stranded:
        flip = rng.random(n_pairs) < 0.5   # fragments on the other strand
        r1, r2 = (np.where(flip[:, None], 3 - r2[:, ::-1], r1),
                  np.where(flip[:, None], 3 - r1[:, ::-1], r2))
    return r1.astype(np.uint8), r2.astype(np.uint8)


def with_errors(rng, reads):
    """``reads`` with substitutions at rate 0.002 and phred+33 qualities
    (12 for 1% of the bases, 8 for 70% of the wrong ones, else 38):
    (codes, quals)."""
    err = rng.random(reads.shape) < 0.002
    reads = np.where(err, (reads + rng.integers(1, 4, reads.shape)) % 4,
                     reads).astype(np.uint8)
    qual = np.where(rng.random(reads.shape) < 0.01, 12, 38)
    qual = np.where(err & (rng.random(reads.shape) < 0.7), 8, qual)
    return reads, (qual + 33).astype(np.uint8)


def write_mates(tmp, name, parts, rng):
    """Concatenate the (r1, r2) ``parts``, shuffle the pairs, add errors
    and write two FASTQ files: their paths and the pair count."""
    r1 = np.concatenate([p[0] for p in parts])
    r2 = np.concatenate([p[1] for p in parts])
    order = rng.permutation(len(r1))
    paths = [os.path.join(tmp, f"{name}_{m}.fastq") for m in (1, 2)]
    for path, reads in zip(paths, (r1[order], r2[order])):
        codes, quals = with_errors(rng, reads)
        write_fastq(path, codes, quals)
    return paths, len(r1)


def packed_kmers(codes, k: int = 21) -> np.ndarray:
    """Canonical k-mers of a code vector (0..3) packed to int64."""
    codes = np.asarray(codes, np.int64)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    fwd = np.zeros(n, np.int64)
    rev = np.zeros(n, np.int64)
    for j in range(k):
        fwd = (fwd << 2) | codes[j:j + n]
        rev = rev | ((3 - codes[j:j + n]) << (2 * j))
    return np.minimum(fwd, rev)


def kmer_set(codes, k: int = 21) -> np.ndarray:
    return np.unique(packed_kmers(codes, k))


def hits_in(kmers: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Which of ``kmers`` lie in the sorted ``table``."""
    if not len(table):
        return np.zeros(len(kmers), bool)
    at = np.minimum(np.searchsorted(table, kmers), len(table) - 1)
    return table[at] == kmers


def kmer_pool(tables):
    """Every table's k-mers (sorted sets) in one sorted array, beside
    the table each came from and the tables' sizes."""
    sizes = np.array([len(t) for t in tables], np.int64)
    pool = np.concatenate(list(tables) + [np.zeros(0, np.int64)])
    owner = np.repeat(np.arange(len(tables)), sizes)
    order = np.argsort(pool, kind="stable")
    return pool[order], owner[order], sizes


def shared_counts(kmers: np.ndarray, pool, owner, n_tables: int):
    """``len(kmers & table)`` for every table of a ``kmer_pool``
    (``kmers`` a sorted set): what ``hits_in(kmers, table).sum()`` gives
    table by table."""
    lo = np.searchsorted(pool, kmers, "left")
    n = np.searchsorted(pool, kmers, "right") - lo
    total = int(n.sum())
    if not total:
        return np.zeros(n_tables, np.int64)
    at = np.repeat(lo - (np.cumsum(n) - n), n) + np.arange(total)
    return np.bincount(owner[at], minlength=n_tables)


def assign_sources(seqs, tables: dict, stride: int = 8) -> list:
    """The source (a key of ``tables``: sorted k-mer sets) most of each
    sequence's sampled 21-mers come from, or None."""
    from spades_for_blackbird_tpu_torch.ops import dna
    out = []
    for s in seqs:
        km = packed_kmers(dna.encode_str(s))[::stride]
        if not len(km):
            out.append(None)
            continue
        counts = {name: int(hits_in(km, t).sum())
                  for name, t in tables.items()}
        best = max(counts, key=counts.get)
        out.append(best if 2 * counts[best] >= len(km) else None)
    return out


def best_share(circle: str, seqs) -> float:
    """The largest share of ``circle``'s 21-mers (wrap included) that one
    of ``seqs`` holds."""
    from spades_for_blackbird_tpu_torch.ops import dna
    want = kmer_set(dna.encode_str(circle + circle[:20]))
    best = 0.0
    for s in seqs:
        if len(s) < 0.9 * len(circle):
            continue
        got = kmer_set(dna.encode_str(s))
        best = max(best, float(hits_in(want, got).sum()) / len(want))
    return best


def fasta_records(path: str) -> list[tuple[str, str]]:
    from spades_for_blackbird_tpu_torch.io import fastq
    names, seqs = fastq.read_sequences(path)
    return list(zip(names, seqs))


def same_records(a, b, what: str) -> None:
    """Two FASTA files' records: the same names but for the coverage
    field (rtol COV_RTOL) and the same sequences."""
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} records vs {len(b)}")
    for (na, sa), (nb, sb) in zip(a, b):
        ha, ta = na.split("_cov_", 1) if "_cov_" in na else (na, "")
        hb, tb = nb.split("_cov_", 1) if "_cov_" in nb else (nb, "")
        ca = re.match(r"[0-9.]+", ta)
        cb = re.match(r"[0-9.]+", tb)
        if sa != sb or ha != hb or (ca is None) != (cb is None) or (
                ca and ta[ca.end():] != tb[cb.end():]):
            raise AssertionError(f"{what}: {na} differs from {nb}")
        if ca and not np.isclose(float(ca.group()), float(cb.group()),
                                 rtol=COV_RTOL, atol=1e-6):
            raise AssertionError(f"{what}: coverage of {na} vs {nb}")


def mode_run(device, argv, kernel):
    """``counted_cli`` read for the k-mer kernel (``kernel``): (wall s,
    launches, launches by stage, peak device bytes)."""
    wall, launches, by_stage, peak = counted_cli(device, argv)
    name = next(n for n, k in all_kernels().items() if k is kernel)
    return wall, launches[name], {stage: n[name] for stage, n in
                                  by_stage.items()}, peak


def log_lines(out: str, needles) -> list[str]:
    with open(os.path.join(out, "spades.log")) as f:
        return [ln.strip() for ln in f if any(n in ln for n in needles)]


def community_20kb(tmp, rng):
    """Phase 3's data for the modes: FR pairs of a 15 kb and an 8 kb
    genome at 40x and a 3 kb circular plasmid at 60x."""
    from spades_for_blackbird_tpu_torch.ops import dna
    from spades_for_blackbird_tpu_torch.utils import simulate
    parts = []
    for size, seed, cov, circ in ((15_000, 3, 40, False),
                                  (8_000, 4, 40, False),
                                  (3_000, 5, 60, True)):
        g = dna.encode_str(simulate.random_genome(size, seed=seed))
        parts.append(sample_pairs(rng, g, size * cov // 200,
                                  circular=circ))
    return write_mates(tmp, "community", parts, rng)[0]


MODE_RUNS = (("meta", ["--meta", "-k", "21"]),
             ("plasmid", ["--plasmid", "-k", "21"]),
             ("metaplasmid", ["--metaplasmid", "-k", "21"]),
             ("metaviral", ["--metaviral", "-k", "21"]),
             ("rnaviral", ["--rnaviral", "-k", "21"]),
             ("rna", ["--rna", "--ss", "fr", "-k", "21"]),
             ("moleculo", ["--moleculo", "-k", "21"]))


# what card and CPU runs of a command line must write alike: FASTA
# (coverage in the headers within rtol COV_RTOL), and exactly these
SAME_FILES = (".paths", ".lib_data", "bgc_statistics.txt",
              "domain_graph.dot")


def compare_outputs(card: str, cpu: str, name: str):
    """The files of two output directories of one command line, card and
    CPU: the same FASTA, ``.paths``, ``.lib_data`` and HMM files
    (``temp_anti/`` included), and the same GFA segments, links and
    P-lines. Returns (file names, segments, P-lines)."""
    def listed(d):
        return sorted(os.path.relpath(os.path.join(r, n), d)
                      for r, _, ns in os.walk(d) for n in ns
                      if n.endswith((".fasta",) + SAME_FILES))
    files = listed(cpu)
    if files != listed(card):
        raise AssertionError(f"{name}: the card and the CPU wrote other "
                             f"files")
    for fname in files:
        if fname.endswith(".fasta"):
            same_records(fasta_records(os.path.join(card, fname)),
                         fasta_records(os.path.join(cpu, fname)),
                         f"{name} {fname}")
        else:
            texts = [open(os.path.join(d, fname)).read()
                     for d in (card, cpu)]
            if texts[0] != texts[1]:
                raise AssertionError(f"{name} {fname} differs")
    (sa, la, pa), (sb, lb, pb) = (gfa_records(os.path.join(
        d, "assembly_graph_with_scaffolds.gfa")) for d in (card, cpu))
    if [x[:2] for x in sa] != [x[:2] for x in sb] or la != lb \
            or pa != pb or not np.allclose(
                [x[2] for x in sa], [x[2] for x in sb],
                rtol=COV_RTOL, atol=1e-6):
        raise AssertionError(f"{name}: GFA segments, links or paths "
                             f"differ between card and CPU")
    return files, sa, pa


def cpu_cli(argv, out: str):
    """The command line on the CPU in a child process (the package's
    ``__main__``, CPU_RUN_THREADS threads, its log in ``out.log``; an
    argument ``{dev}`` names the device): (return code, wall s)."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS=str(CPU_RUN_THREADS))
    t0 = time.perf_counter()
    with open(out + ".log", "w") as f:
        rc = subprocess.run(
            [sys.executable, "-m", PACKAGE]
            + [a.format(dev="cpu") for a in argv]
            + ["-o", out, "--device", "cpu"], cwd=REPO, env=env, stdout=f,
            stderr=subprocess.STDOUT, timeout=CPU_RUN_TIMEOUT).returncode
    return rc, time.perf_counter() - t0


class CardAndCpu:
    """Command lines run on the card in this process and on the CPU in
    child processes, CPU_RUN_WIDTH at a time from when they are
    submitted, so the CPU's runs overlap the card's and each other. Use
    as a context manager: leaving it waits for every child it started
    and starts no queued one."""

    def __init__(self, device, root: str):
        self.device, self.root = device, root
        self.pool = ThreadPoolExecutor(max_workers=CPU_RUN_WIDTH)
        self.cpu = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.pool.shutdown(wait=True, cancel_futures=True)

    def submit(self, name: str, argv) -> None:
        """Start (or queue) ``name``'s CPU run."""
        self.cpu[name] = self.pool.submit(
            cpu_cli, argv, os.path.join(self.root, name, "cpu"))

    def run(self, name: str, argv):
        """``cli.main(argv)`` on the card into ``root/name/<device>``,
        then the CPU's run of it (submitted now unless it was): the walls
        and the two output directories; raises unless both return 0."""
        from spades_for_blackbird_tpu_torch import cli
        if name not in self.cpu:
            self.submit(name, argv)
        card = os.path.join(self.root, name, str(self.device))
        t0 = time.perf_counter()
        rc = cli.main([a.format(dev=str(self.device)) for a in argv]
                      + ["-o", card, "--device", str(self.device)])
        card_s = time.perf_counter() - t0
        cpu_rc, cpu_s = self.cpu[name].result()
        cpu = os.path.join(self.root, name, "cpu")
        if rc != 0 or cpu_rc != 0:
            with open(cpu + ".log") as f:
                tail = f.read()[-2000:]
            raise AssertionError(f"cli.main {name}: card returned {rc}, "
                                 f"CPU returned {cpu_rc}:\n{tail}")
        return {str(self.device): card_s, "cpu": cpu_s}, (card, cpu)


def modes_gpu_vs_cpu(device) -> dict:
    """Phase 3 for the modes: each through the command line on the card
    and on the CPU, on FR pairs of a 26 kb community with a circle:
    identical contigs, scaffolds, GFA segments, links and P-lines,
    ``.paths``, ``final.lib_data``, circular and linear candidates and
    components."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_modes_")
    record = {}
    try:
        mates = community_20kb(tmp, np.random.default_rng(6))
        argvs = {name: ["-1", mates[0], "-2", mates[1], "--only-assembler",
                        "--checkpoints", "none"] + flags
                 for name, flags in MODE_RUNS}
        with CardAndCpu(device, tmp) as both:
            for name, argv in argvs.items():
                both.submit(name, argv)
            done = {name: both.run(name, argv)
                    for name, argv in argvs.items()}
        for name, flags in MODE_RUNS:
            walls, (card, cpu) = done[name]
            files, sa, pa = compare_outputs(card, cpu, name)
            contigs = fasta_records(os.path.join(card, "contigs.fasta"))
            record[name] = {"files": files, "contigs": len(contigs),
                            "segments": len(sa), "paths": len(pa),
                            "gpu_s": walls[str(device)],
                            "cpu_s": walls["cpu"]}
            log(f"[gpu-vs-cpu] 26 kb community {' '.join(flags)}: "
                f"{len(contigs)} contigs, {len(sa)} segments, {len(pa)} "
                f"P-lines, identical {', '.join(files)}; card "
                f"{walls[str(device)]:.2f} s, cpu {walls['cpu']:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return record


# phase 12: (name, size, seed, GC, coverage) of the community's genomes
META_GENOMES = (("g1", 2_000_000, 21, 0.40, 80.0),
                ("g2", 1_500_000, 22, 0.50, 40.0),
                ("g3", 1_000_000, 23, 0.60, 20.0),
                ("g4", 500_000, 24, 0.45, 8.0))
ISLAND = 20_000        # strain window of g1 copied into g2
ISLAND_AT = (700_000, 400_000)   # its start in g1 and in g2
# (name, size, seed, coverage) of the circles: a 12 kb plasmid at 10
# copies of g1, a 60 kb one at 3 copies, a phage at 150x
META_CIRCLES = (("plasmid_12k", 12_000, 31, 800.0),
                ("plasmid_60k", 60_000, 32, 240.0),
                ("phage_45k", 45_000, 33, 150.0))
META_FRACTION = 0.95   # genome fraction bar of genomes at >= 20x
CIRCLE_SHARE = 0.90    # share of a circle one record must hold


def metagenome(scale: float = 1.0):
    """Phase 12's community: {name: genome}, {name: circle}, and the
    island's windows in g1 and g2 ((start, end) pairs). ``scale`` cuts
    the genomes (not the circles) for a rehearsal on the CPU."""
    from spades_for_blackbird_tpu_torch.ops import dna
    from spades_for_blackbird_tpu_torch.utils import simulate
    genomes = {name: simulate.random_genome(
        int(size * scale), seed=seed, gc=gc,
        repeats=[(2000, 3), (700, 4), (400, 6)])
        for name, size, seed, gc, _ in META_GENOMES}
    rng = np.random.default_rng(25)
    a, b = (int(p * scale) for p in ISLAND_AT)
    n = int(ISLAND * scale)
    island = dna.encode_str(genomes["g1"][a:a + n])
    hit = rng.random(n) < 0.01
    island[hit] = (island[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    g2 = genomes["g2"]
    genomes["g2"] = g2[:b] + dna.decode_codes(island) + g2[b + n:]
    circles = {name: simulate.random_genome(size, seed=seed)
               for name, size, seed, _ in META_CIRCLES}
    return genomes, circles, {"g1": (a, a + n), "g2": (b, b + n)}


def metagenome_reads(tmp, genomes, circles, rng):
    from spades_for_blackbird_tpu_torch.ops import dna
    cov = {name: c for name, _, _, _, c in META_GENOMES}
    cov.update({name: c for name, _, _, c in META_CIRCLES})
    parts = []
    for name, seq in list(genomes.items()) + list(circles.items()):
        parts.append(sample_pairs(
            rng, dna.encode_str(seq), int(len(seq) * cov[name] / 200),
            circular=name in circles))
    return write_mates(tmp, "meta", parts, rng)


def grade_metagenome(out, genomes, circles, windows) -> dict:
    """Each genome graded with ``utils/assess`` on the contigs whose
    21-mers come mostly from it; misassemblies of contigs that touch the
    island's windows are counted apart."""
    from spades_for_blackbird_tpu_torch.ops import dna
    from spades_for_blackbird_tpu_torch.utils import assess
    tables = {name: kmer_set(dna.encode_str(s))
              for name, s in list(genomes.items()) + list(circles.items())}
    island = np.union1d(*(kmer_set(dna.encode_str(genomes[g][lo:hi]))
                          for g, (lo, hi) in windows.items()))
    seqs = [s for s, _ in read_fasta(os.path.join(out, "contigs.fasta"))]
    source = assign_sources(seqs, tables)
    grades = {}
    for name, genome in genomes.items():
        mine = [s for s, src in zip(seqs, source) if src == name]
        rep = assess.assess(mine, genome)
        near = [hits_in(packed_kmers(dna.encode_str(s))[::8], island).any()
                for s in mine]
        outside = sum(pc.get("misassemblies", 0)
                      for pc, isl in zip(rep.per_contig, near) if not isl)
        grades[name] = dict(rep.to_dict(), misassemblies_outside_island=
                            outside, island_contigs=int(sum(near)))
    grades["unassigned_contigs"] = sum(src is None for src in source)
    return grades


def phase_metagenome(device, tmp, scale: float = 1.0) -> dict:
    """Phase 12: the metagenome at full size, (a) ``-1/-2 --meta``, (b)
    ``--metaplasmid --only-assembler`` and (c) ``--metaviral
    --only-assembler`` on the same reads."""
    from spades_for_blackbird_tpu_torch.ops import dna, kmer_cuda
    kernel = kmer_cuda.extract_sort_keys
    t0 = time.perf_counter()
    genomes, circles, windows = metagenome(scale)
    mates, pairs = metagenome_reads(tmp, genomes, circles,
                                    np.random.default_rng(26))
    log(f"[meta] community of {len(genomes)} genomes "
        f"({sum(map(len, genomes.values()))} bp) and {len(circles)} circles:"
        f" 2 x {pairs} reads simulated and written in "
        f"{time.perf_counter() - t0:.1f} s")
    record = {"reads": 2 * pairs}
    out = os.path.join(tmp, "meta")
    argv = ["-1", mates[0], "-2", mates[1], "-o", out, "--meta",
            "--checkpoints", "none", "--trace-time"]
    with plain_extraction_refused():
        wall, launches, by_stage, peak = mode_run(device, argv, kernel)
    stages, spans = stage_seconds(out, [
        "read_conversion", "error_correction", "k21", "k33", "k55",
        "gap_closing", "repeat_resolution", "second_phase_setup",
        "repeat_resolution_2", "contig_output"])
    grades = grade_metagenome(out, genomes, circles, windows)
    log(f"[meta] cli.main -1 -2 --meta: {wall:.2f} s, peak device memory "
        f"{peak / 2**30:.2f} GiB, kernel launches {launches} {by_stage}")
    for name, sec in stages.items():
        log(f"[meta] stage {name}: {sec:.3f} s")
    for name in ("red", "second_phase", "rcc", "hidden_ec", "simplify",
                 "coverage_model_fit", "condense"):
        log(f"[meta] scope {name}: {spans.get(name, 0.0):.3f} s")
    for name in genomes:
        gr = grades[name]
        log(f"[meta] {name}: {gr['n_contigs']} contigs, NG50 {gr['ng50']},"
            f" genome fraction {gr['genome_fraction']:.5f}, misassemblies "
            f"{gr['misassemblies']} ({gr['misassemblies_outside_island']} "
            f"outside the island, {gr['island_contigs']} island contigs)")
    log(f"[meta] contigs from no one source: {grades['unassigned_contigs']}")
    if by_stage.get("second_phase_setup", 0) <= 0:
        raise AssertionError("second_phase_setup never launched the kernel")
    for name, _, _, _, cov in META_GENOMES:
        gr = grades[name]
        if gr["misassemblies_outside_island"]:
            raise AssertionError(f"--meta: misassemblies in {name}: {gr}")
        if cov >= 20 and gr["genome_fraction"] < META_FRACTION:
            raise AssertionError(f"--meta: {name} genome fraction "
                                 f"{gr['genome_fraction']:.4f} < "
                                 f"{META_FRACTION}")
    record["meta"] = {"wall_s": wall, "launches": launches,
                      "launches_by_stage": by_stage, "peak_bytes": peak,
                      "stages_s": stages, "spans_s": spans,
                      "grades": grades}
    tables = {name: kmer_set(dna.encode_str(s))
              for name, s in genomes.items()}
    # phase 16's community: the reads, the --meta run's graph and contigs,
    # and its segments annotated with the genome most of their 21-mers
    # come from
    from spades_for_blackbird_tpu_torch.io import gfa as gfa_io
    keep = {"mates": mates, "gfa": os.path.join(tmp, "meta_graph.gfa"),
            "contigs": os.path.join(tmp, "meta_contigs.fasta"),
            "ann": os.path.join(tmp, "meta_bins.ann")}
    shutil.copy(os.path.join(out, "assembly_graph_with_scaffolds.gfa"),
                keep["gfa"])
    shutil.copy(os.path.join(out, "contigs.fasta"), keep["contigs"])
    segs, _ = gfa_io.read_gfa(keep["gfa"])
    names = [n for n, (sq, _) in segs.items() if len(sq) >= 500]
    src = assign_sources([segs[n][0] for n in names], tables)
    with open(keep["ann"], "w") as f:
        f.write("".join(f"{n}\t{b}\n" for n, b in zip(names, src) if b))
    shutil.rmtree(out)

    for mode in ("metaplasmid", "metaviral"):
        out = os.path.join(tmp, mode)
        argv = ["-1", mates[0], "-2", mates[1], "-o", out, f"--{mode}",
                "--only-assembler", "-k", str(FULL_K), "--checkpoints",
                "none", "--trace-time"]
        with plain_extraction_refused():
            wall, launches, by_stage, peak = mode_run(device, argv, kernel)
        stages, spans = stage_seconds(out, [
            "read_conversion", f"k{FULL_K}", "gap_closing",
            "chromosome_removal", "repeat_resolution", "second_phase_setup",
            "repeat_resolution_2", "contig_output"])
        cutoffs = log_lines(out, ["metaplasmid cutoff"])
        comps = [s for f in sorted(os.listdir(out))
                 if f.startswith("components_")
                 for _, s in fasta_records(os.path.join(out, f))]
        circ = fasta_records(os.path.join(out, "contigs.circular.fasta"))
        src = assign_sources(comps, tables)
        chrom_bases = sum(len(s) for s, x in zip(comps, src) if x)
        shares = {name: best_share(c, comps + [s for _, s in circ])
                  for name, c in circles.items()}
        log(f"[meta] cli.main --{mode} --only-assembler -k {FULL_K}: "
            f"{wall:.2f} s, peak "
            f"device memory {peak / 2**30:.2f} GiB, kernel launches "
            f"{launches} {by_stage}; {len(cutoffs)} cutoff rounds, "
            f"chromosome_removal {spans.get('chromosome_removal', 0.0):.3f} "
            f"s; {len(comps)} component records of "
            f"{sum(map(len, comps))} bases, {chrom_bases} of them "
            f"chromosomal; circles held {shares}")
        for name, sec in stages.items():
            log(f"[meta] {mode} stage {name}: {sec:.3f} s")
        for line in cutoffs[:3] + cutoffs[-2:] + log_lines(
                out, ["chromosome removal:", "circular output",
                      "linear viral"]):
            log(f"[meta] {mode} log: {line}")
        for name, share in shares.items():
            if share < CIRCLE_SHARE:
                raise AssertionError(f"--{mode}: no record holds "
                                     f"{CIRCLE_SHARE:.0%} of {name} "
                                     f"({share:.3f})")
        rec = {"wall_s": wall, "launches": launches,
               "launches_by_stage": by_stage, "peak_bytes": peak,
               "stages_s": stages, "spans_s": spans,
               "cutoff_rounds": len(cutoffs), "component_records":
               len(comps), "chromosomal_bases": chrom_bases,
               "circle_shares": shares}
        if mode == "metaviral":
            linears = os.path.join(out, "contigs.linears.fasta")
            if not os.path.exists(linears):
                raise AssertionError("--metaviral wrote no "
                                     "contigs.linears.fasta")
            phage = best_share(circles["phage_45k"], [
                s for n, s in circ if n.endswith("_circular")])
            log(f"[meta] metaviral: the phage's share in a circular record "
                f"{phage:.3f}; {len(fasta_records(linears))} linear "
                f"candidates")
            if phage < CIRCLE_SHARE:
                raise AssertionError("--metaviral does not list the phage "
                                     "as circular")
            rec["phage_circular_share"] = phage
        record[mode] = rec
        shutil.rmtree(out)
    record["files"] = keep
    return record


# phase 13: (name, size, seed, copies of the chromosome) of the plasmids
PLASMIDS = (("plasmid_12k", 12_000, 41, 10), ("plasmid_60k", 60_000, 42, 3))


def phase_plasmid(device, genome, codes, quals, tmp) -> dict:
    """Phase 13: ``-1/-2 --plasmid`` on phase 8's reads plus two circular
    plasmids over the 10 kb small-component bound."""
    from spades_for_blackbird_tpu_torch.ops import dna, kmer_cuda
    from spades_for_blackbird_tpu_torch.utils import simulate
    kernel = kmer_cuda.extract_sort_keys
    rng = np.random.default_rng(43)
    t0 = time.perf_counter()
    half = codes.shape[0] // 2
    plasmids = {name: simulate.random_genome(size, seed=seed)
                for name, size, seed, _ in PLASMIDS}
    extra = [sample_pairs(rng, dna.encode_str(plasmids[name]),
                          int(size * FULL_COVERAGE * copies / 200),
                          circular=True)
             for name, size, _, copies in PLASMIDS]
    mates = [os.path.join(tmp, f"plasmid_{m}.fastq") for m in (1, 2)]
    for m, path in enumerate(mates):
        ec, eq = with_errors(rng, np.concatenate([e[m] for e in extra]))
        part = slice(0, half) if m == 0 else slice(half, None)
        write_fastq(path, np.concatenate([codes[part], ec]),
                    np.concatenate([quals[part], eq]))
    n_extra = sum(len(e[0]) for e in extra)
    log(f"[plasmid] phase 8's 2 x {half} reads plus 2 x {n_extra} of the "
        f"plasmids written in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(tmp, "plasmid")
    argv = ["-1", mates[0], "-2", mates[1], "-o", out, "--plasmid", "-k",
            str(FULL_K), "--checkpoints", "none", "--trace-time"]
    with plain_extraction_refused():
        wall, launches, by_stage, peak = mode_run(device, argv, kernel)
    stages, spans = stage_seconds(out, [
        "read_conversion", "error_correction", "k21", "k33", "k55",
        "gap_closing", "chromosome_removal", "repeat_resolution",
        "contig_output"])
    seqs = [s for s, _ in read_fasta(os.path.join(out, "contigs.fasta"))]
    circ = [s for _, s in fasta_records(
        os.path.join(out, "contigs.circular.fasta"))]
    shares = {name: best_share(p, seqs + circ)
              for name, p in plasmids.items()}
    chrom = kmer_set(dna.encode_str(genome))
    src = assign_sources(seqs, {"chromosome": chrom})
    chrom_bases = sum(len(s) for s, x in zip(seqs, src) if x)
    total = sum(map(len, seqs))
    log(f"[plasmid] cli.main -1 -2 --plasmid: {wall:.2f} s, peak device "
        f"memory {peak / 2**30:.2f} GiB, kernel launches {launches} "
        f"{by_stage}; {len(seqs)} contigs of {total} bases, the "
        f"chromosome's share {chrom_bases / max(total, 1):.4f}; "
        f"{len(circ)} circular candidates; plasmids held {shares}")
    for name, sec in stages.items():
        log(f"[plasmid] stage {name}: {sec:.3f} s")
    for line in log_lines(out, ["chromosome removal:", "circular output"]):
        log(f"[plasmid] log: {line}")
    for name, share in shares.items():
        if share < CIRCLE_SHARE:
            raise AssertionError(f"--plasmid: no record holds "
                                 f"{CIRCLE_SHARE:.0%} of {name} "
                                 f"({share:.3f})")
    shutil.rmtree(out)
    for path in mates:
        os.remove(path)
    return {"wall_s": wall, "launches": launches,
            "launches_by_stage": by_stage, "peak_bytes": peak,
            "stages_s": stages, "spans_s": spans, "contigs": len(seqs),
            "bases": total, "chromosome_bases": chrom_bases,
            "plasmid_shares": shares}


RNA_GENES = 1000
RNA_MAX_PAIRS = 2_000_000
RNA_K = 49                # phase 14 (a): the last rung of the rna ladder
ISOFORM_COVERAGE = 20.0   # isoforms graded: expressed at >= 20x
ISOFORM_SHARE = 0.90      # share of an isoform one contig must hold
# share of the graded isoforms that must pass. The strand split of both
# packages counts the second mate of a stranded FR pair on the other
# strand, so it cuts most transcripts in two; on a 1/20 cut of this data
# the JAX package keeps 21 of 34 isoforms before the split and 1 of 34
# after it, with a graph bit-equal to the port's (ROADMAP.md, Queue 3).
# The bar guards against a broken assembly, not against the reference.
ISOFORM_BAR = 0.10
VIRUS_COVERAGE = 1000.0   # phase 14 (b): 2,000x until phase 16 came


def transcriptome(rng, n_genes: int):
    """Genes of 2-6 exons with 1-3 isoforms each (the first has every
    exon, the others skip one internal exon), transcripts of 500-5,000
    bases; 10% of the genes overlap their neighbour antisense (their
    first exon begins with the reverse complement of the neighbour's
    last 300 bases). Returns [(isoform, coverage)]: coverage log-normal,
    median 20x, sigma 1.5, capped at 2,000x, shared by a gene's isoforms
    in 60/30/10 shares."""
    from spades_for_blackbird_tpu_torch.utils import simulate
    out = []
    prev_last = None
    for gene in range(n_genes):
        n_ex = int(rng.integers(2, 7))
        length = int(rng.integers(500, 5001))
        cuts = np.sort(rng.choice(np.arange(100, length - 99), n_ex - 1,
                                  replace=False))
        full = simulate.random_genome(length, seed=1000 + gene,
                                      gc=float(rng.uniform(0.4, 0.6)))
        if prev_last is not None and rng.random() < 0.10:
            full = revcomp(prev_last) + full[300:]
        exons = np.split(np.frombuffer(full.encode(), np.uint8),
                         cuts)
        exons = [e.tobytes().decode() for e in exons]
        prev_last = exons[-1][-300:] if len(exons[-1]) >= 300 else None
        expr = min(20.0 * float(np.exp(1.5 * rng.standard_normal())),
                   2000.0)
        n_iso = min(int(rng.integers(1, 4)), max(1, n_ex - 1))
        skips = [None] + list(rng.choice(np.arange(1, n_ex - 1),
                                         n_iso - 1, replace=False)
                              if n_ex > 2 else [])
        for share, skip in zip((0.6, 0.3, 0.1) if len(skips) > 1 else (1.0,),
                               skips):
            iso = "".join(e for i, e in enumerate(exons) if i != skip)
            out.append((iso, expr * share))
    return out


def revcomp(s: str) -> str:
    from spades_for_blackbird_tpu_torch.ops import dna
    return dna.revcomp_str(s)


def phase_rna(device, tmp, scale: float = 1.0) -> dict:
    """Phase 14: (a) ``-1/-2 --rna --ss fr`` on stranded pairs of a
    simulated transcriptome; (b) ``-1/-2 --rnaviral`` on a 30 kb virus as
    three haplotypes."""
    from spades_for_blackbird_tpu_torch.ops import dna, kmer_cuda
    from spades_for_blackbird_tpu_torch.utils import assess, simulate
    kernel = kmer_cuda.extract_sort_keys
    rng = np.random.default_rng(51)
    t0 = time.perf_counter()
    isoforms = transcriptome(rng, max(int(RNA_GENES * scale), 4))
    want = sum(len(s) * c / 200 for s, c in isoforms)
    cut = min(1.0, RNA_MAX_PAIRS * scale / want)
    parts = [sample_pairs(rng, dna.encode_str(s), int(len(s) * c * cut
                                                      / 200),
                          stranded=True, insert_mean=250.0)
             for s, c in isoforms]
    mates, pairs = write_mates(tmp, "rna", parts, rng)
    log(f"[rna] {len(isoforms)} isoforms of {int(RNA_GENES * scale)} genes "
        f"({sum(len(s) for s, _ in isoforms)} bases), stranded 2 x {pairs} "
        f"reads (coverage x{cut:.3f}) written in "
        f"{time.perf_counter() - t0:.1f} s")
    out = os.path.join(tmp, "rna")
    argv = ["-1", mates[0], "-2", mates[1], "-o", out, "--rna", "--ss",
            "fr", "-k", str(RNA_K), "--checkpoints", "none", "--trace-time"]
    with plain_extraction_refused():
        wall, launches, by_stage, peak = mode_run(device, argv, kernel)
    stages, spans = stage_seconds(out, [
        "read_conversion", "error_correction", f"k{RNA_K}",
        "ss_edge_split", "gap_closing", "repeat_resolution",
        "contig_output"])
    seqs = [s for s, _ in read_fasta(os.path.join(out, "contigs.fasta"))]
    pool, owner, sizes = kmer_pool([kmer_set(dna.encode_str(s))
                                    for s in seqs])
    graded, held = 0, 0
    for iso, cov in isoforms:
        if cov * cut < ISOFORM_COVERAGE:
            continue
        graded += 1
        km = kmer_set(dna.encode_str(iso))
        need = ISOFORM_SHARE * len(km)
        # one contig of at least ``need`` k-mers holding ``need`` of them
        if ((shared_counts(km, pool, owner, len(sizes)) >= need)
                & (sizes >= need)).any():
            held += 1
    share = held / max(graded, 1)
    log(f"[rna] cli.main -1 -2 --rna --ss fr -k {RNA_K}: {wall:.2f} s, "
        f"peak device "
        f"memory {peak / 2**30:.2f} GiB, kernel launches {launches} "
        f"{by_stage}; {len(seqs)} contigs; isoforms at >= "
        f"{ISOFORM_COVERAGE:g}x held at >= {ISOFORM_SHARE:.0%} by one "
        f"contig: {held} of {graded} ({share:.4f})")
    for name, sec in stages.items():
        log(f"[rna] stage {name}: {sec:.3f} s")
    for name in ("superbubble", "low_complexity", "ss_edge_split",
                 "simplify", "coverage_model_fit"):
        log(f"[rna] scope {name}: {spans.get(name, 0.0):.3f} s")
    for line in log_lines(out, ["ss edge split"]):
        log(f"[rna] log: {line}")
    if by_stage.get("ss_edge_split", 0) <= 0:
        raise AssertionError("ss_edge_split never launched the kernel")
    if share < ISOFORM_BAR:
        raise AssertionError(f"--rna: {share:.3f} of the isoforms held, "
                             f"under {ISOFORM_BAR}")
    record = {"isoforms": len(isoforms), "reads": 2 * pairs,
              "coverage_cut": cut, "rna": {
                  "wall_s": wall, "launches": launches,
                  "launches_by_stage": by_stage, "peak_bytes": peak,
                  "stages_s": stages, "spans_s": spans,
                  "graded": graded, "held": held}}
    shutil.rmtree(out)
    for path in mates:
        os.remove(path)

    # (b) a 30 kb RNA virus as three haplotypes, 80/15/5 at VIRUS_COVERAGE
    major = simulate.random_genome(int(30_000 * max(scale, 0.1)), seed=52)
    g = dna.encode_str(major)
    parts = []
    for div, mix in ((0.0, 0.80), (0.01, 0.15), (0.03, 0.05)):
        hap = g.copy()
        hit = rng.random(len(g)) < div
        hap[hit] = (hap[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        parts.append(sample_pairs(rng, hap,
                                  int(len(g) * VIRUS_COVERAGE * mix / 200)))
    mates, pairs = write_mates(tmp, "virus", parts, rng)
    out = os.path.join(tmp, "rnaviral")
    argv = ["-1", mates[0], "-2", mates[1], "-o", out, "--rnaviral",
            "--checkpoints", "none", "--trace-time"]
    with plain_extraction_refused():
        wall, launches, by_stage, peak = mode_run(device, argv, kernel)
    stages, spans = stage_seconds(out, [
        "read_conversion", "error_correction", "k21", "k33", "k49",
        "gap_closing", "repeat_resolution", "contig_output"])
    rep = assess.assess([s for s, _ in read_fasta(
        os.path.join(out, "contigs.fasta"))], major)
    log(f"[rna] cli.main -1 -2 --rnaviral, 2 x {pairs} reads: {wall:.2f} "
        f"s, peak device memory {peak / 2**30:.2f} GiB, kernel launches "
        f"{launches}; the major haplotype: {rep.n_contigs} contigs, NG50 "
        f"{rep.ng50}, genome fraction {rep.genome_fraction:.5f}, "
        f"misassemblies {rep.misassemblies}; red "
        f"{spans.get('red', 0.0):.3f} s")
    for name, sec in stages.items():
        log(f"[rna] rnaviral stage {name}: {sec:.3f} s")
    if rep.genome_fraction < META_FRACTION:
        raise AssertionError(f"--rnaviral: the major haplotype's genome "
                             f"fraction {rep.genome_fraction:.4f}")
    record["rnaviral"] = {"wall_s": wall, "launches": launches,
                          "launches_by_stage": by_stage, "peak_bytes": peak,
                          "stages_s": stages, "spans_s": spans,
                          "reads": 2 * pairs, "assess": rep.to_dict()}
    shutil.rmtree(out)
    for path in mates:
        os.remove(path)
    return record


# ---------------------------------------------------------------------
# Hybrid long reads, the HMM modes and the series analysis (phases 2, 3,
# 15): the hand kernels with no TPU counterpart
# ---------------------------------------------------------------------

ED_SOURCE = f"{PACKAGE}/csrc/banded_ed.cu"
ED_REPLACES = "spades_for_blackbird_tpu/ops/align.py:25"
VITERBI_SOURCE = f"{PACKAGE}/csrc/viterbi.cu"
VITERBI_REPLACES = "spades_for_blackbird_tpu/ops/hmm.py:89"
FP32_OPS_PER_S = 67e12   # H100 SXM float32 outside the tensor cores
ED_BAND = 48             # hybrid_close_gaps' band
ED_CELL_OPS = 12         # integer operations a DP cell: 2 adds, 3 mins,
#                          a compare pair, the scan's min and the masks
VITERBI_NODE_OPS = 20    # float32 adds, compares and selects a node a
#                          position (the four-way max, the insert, the
#                          delete chain and its scan, the exit)
VITERBI_PLAIN_CUT = 4000  # positions of each row the plain version runs
ED_BANDS = (0, 1, 15, 16, 48, 511)  # phase 2: one to 32 slots a lane
VITERBI_BATCH_M = (135, 294)  # phase 2: the batched shape's profile
#                               lengths, those of phase 15 (b)'s profiles
VITERBI_BATCH_CUT = 400  # phase 2: positions the plain batched call runs
# phase 2: (m, rows, L) past the block path's 2,048 nodes, and its largest
VITERBI_LONG_CASES = ((2048, 3, 600), (2049, 3, 600), (4000, 3, 600),
                      (5000, 3, 400))
VITERBI_TIMED_M = (2048, 4000)  # timed a position: block and tile path
HYBRID_HOLES = 24        # phase 15 (a): holes in the short reads
HOLE_LEN = (400, 1000)
LONG_COVERAGE = 5.0
LONG_LEN = (2_000, 20_000)
LONG_ERROR = 0.10        # split evenly: substitutions, insertions, deletions
HOLES_BRIDGED = 0.25     # share of the holes one record must span on the
#                          1/20 cut (one stage joins 10 of 24 there, in
#                          both packages: tests/test_torch_long_read.py)
HOLES_BRIDGED_FULL = 0.0  # at full size (PERF.md section 6: random 15-mer
#                          seeds inside a hole break the JAX package's
#                          seed chains there; ROADMAP Queue 3, item 14)
HYBRID_CUT = FULL_GENOME // 20
CLUSTERS = 8             # phase 15 (b): domain clusters planted
DOMAINS = 12             # profiles (one a domain)
DOMAIN_AA = (120, 300)
CLUSTER_DOMAINS = (3, 5)
CLUSTER_GAP = (1_000, 5_000)
HYBRID_3_GENOME = 12_000  # phase 3: the hybrid and HMM command lines
SERIES_K = 21            # phase 15 (c): the profile's k
SERIES_MIN_MULT = 3      # drops most read-error k-mers before the save
SERIES_RTOL = 0.20       # an edge's median sample ratio vs the planted one
SERIES_MIN_EDGE = 1_000  # edges graded for the ratios


SEG_SOURCE = f"{PACKAGE}/csrc/seg_sum.cu"
# the float scatter-add it replaces: an XLA scatter, no Pallas kernel
SEG_REPLACES = "spades_for_blackbird_tpu/graph/condense.py:170"
SEG_REPEATS = 5         # phases 3 and 4: calls held to the CPU's bits
CAREFUL_REPEATS = 3     # phase 3: card runs of --careful against the CPU's
FLOAT32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TOOLS_GENOME = 20_000   # phase 3: the tools' genome
TOOLS_CPU_CHILDREN = 2  # phase 3: child processes running the CPU's tools
TOOLS_K = 55            # phase 16: gbuilder's k
GBUILDER_MIN_COUNT = 3  # phase 16: gbuilder drops rarer (k+1)-mers
KMERCOUNT_K = 21        # phase 16: kmercount and kmer-estimating
HLL_TOLERANCE = 0.06    # phase 16: kmer-estimating against kmercount
POSITIONS_BAR = 0.97    # phase 16: genome share the edge positions cover
SCF_GAPS = 40           # phase 16: N runs planted in phase 8's contigs
SCF_GAP_LEN = 100
BINNED_SHARE = 8        # phase 16: prop-binning bins 1/8 of the first mates
TOOLS_BUDGET_S = 90.0   # phase 16's wall, reported against it


SEG_CHAIN_ADDS = 1 << 22  # the one-thread chain phase 2 times
_CHAIN_NS = {}


def add_latency_ns(dtype) -> float:
    """ns of one dependent add (``__fadd_rn`` / ``__dadd_rn``) on the
    card: one thread through SEG_CHAIN_ADDS adds (``seg_sum.add_chain``),
    CUDA events, measured once a dtype a run."""
    import torch
    from spades_for_blackbird_tpu_torch.ops import seg_sum
    if dtype not in _CHAIN_NS:
        buf = torch.linspace(0.5, 1.5, 9, dtype=dtype, device="cuda")
        ms = cuda_ms(lambda: seg_sum.seg_sum.add_chain(buf, SEG_CHAIN_ADDS),
                     3)
        _CHAIN_NS[dtype] = ms * 1e6 / SEG_CHAIN_ADDS
        log(f"[kernel] seg_sum: one dependent {dtype} add takes "
            f"{_CHAIN_NS[dtype]:.4f} ns (one thread, {SEG_CHAIN_ADDS} adds)")
    return _CHAIN_NS[dtype]


def seg_sum_bound(M: int, C: int, slots: int, itemsize: int,
                  slot_bytes: int, longest: int, add_ns: float):
    """(bound ms, what bounds it, the byte bound ms, the chain bound ms)
    of one ordered segment sum over the M rows it keeps (the rows keyed
    at the limit are skipped, not read): their sorted slots (with the
    permutation
    where the kernel reads through it: ``slot_bytes`` a row) and the rows
    read once, each touched slot's value read and written once; against
    the operations, which are a chain: the longest run's dependent adds
    at ``add_ns`` each (the card's float32 rate over M * C adds is far
    below that)."""
    nbytes = slot_bytes * M + itemsize * M * C + 2 * itemsize * slots * C
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    chain_ms = max(longest * add_ns * 1e-6, M * C / FLOAT32_OPS_PER_S * 1e3)
    return (max(bytes_ms, chain_ms),
            "bytes" if bytes_ms >= chain_ms else "operations",
            bytes_ms, chain_ms)


def float_bits_equal(a, b) -> bool:
    """Two float tensors hold the same bits (a NaN or a signed zero
    included)."""
    import torch
    a, b = a.contiguous().cpu(), b.contiguous().cpu()
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.uint8), b.view(torch.uint8))


def adversarial_rows(rng, n: int, M: int, cols: int, hot_share: float,
                     hot: int, dtype):
    """Scatter rows for the float sums: indices in [0, n] (n the dropped
    slot), ``hot_share`` of them on ``hot`` slots, values of magnitudes
    2^-40 to 2^40 with both signs. Returns (index, values) on the CPU."""
    import torch
    idx = rng.integers(0, n + 1, M)
    on_hot = rng.random(M) < hot_share
    idx[on_hot] = rng.integers(0, hot, int(on_hot.sum()))
    vals = rng.standard_normal((M, cols)) * np.exp2(
        rng.integers(-40, 40, (M, cols)))
    vals = torch.from_numpy(vals if cols > 1 else vals[:, 0]).to(dtype)
    return torch.from_numpy(idx), vals


def seg_sum_row(device, index, src, limit: int, what: str,
                timed: bool) -> dict:
    """The ordered sum of one scatter's rows on the card: the kernel on
    the rows as the route sorts them and copies them out, and on the
    unsorted rows read through the sort's permutation, each with the
    sort's int32 slots and with the same slots as int64 (the keys of a
    limit past 2^31), against its plain version (the CPU's ``index_add_``
    on those rows) bit for bit, and the route
    (``segments.index_add_float``) against the CPU's ``index_add_`` on
    the rows in their own order, ``SEG_REPEATS`` calls. Timed: the bare
    launch as the route makes it, the route, the plain version (CPU) and
    ``index_add_`` on the card (the library call: the same sums, added in
    the order threads arrive), beside the byte bound and the chain bound
    of the rows the kernel sums (those below the limit)."""
    import torch
    from spades_for_blackbird_tpu_torch.ops import seg_sum, segments
    kernel = seg_sum.seg_sum
    cols = 1 if src.dim() == 1 else src.shape[1]
    shape = (limit + 1,) if cols == 1 else (limit + 1, cols)
    init = torch.zeros(shape, dtype=src.dtype)
    want = init.clone().index_add_(0, index, src)[:limit]
    idx_d, src_d = index.to(device), src.to(device)
    for rep in range(SEG_REPEATS):
        got = segments.index_add_float(init.clone().to(device), idx_d,
                                       src_d, limit=limit)[:limit]
        if not float_bits_equal(got, want):
            raise AssertionError(f"ordered float sum ({what}) != the CPU's "
                                 f"index_add_ on call {rep + 1}")
    slot, perm = segments.sorted_slots(idx_d, limit)
    rows = src_d.reshape(len(index), cols)
    vals = rows[perm]
    out = init.clone().to(device).view(limit + 1, cols)
    plain = seg_sum.seg_sum_plain(out.clone().cpu(), slot.cpu(),
                                  vals.cpu(), limit=limit)
    err = 0.0
    for keys in (slot, slot.to(torch.int64)):
        got = kernel(out.clone(), keys, vals, limit=limit)
        through = kernel(out.clone(), keys, rows, perm=perm, limit=limit)
        if not (float_bits_equal(got, plain)
                and float_bits_equal(through, plain)):
            raise AssertionError(f"seg_sum kernel != plain ({what}, "
                                 f"{keys.dtype} slots)")
        if got.numel():
            err = max(err, float((got.cpu().double() - plain.double())
                                 .abs().max()))
    kept = slot[slot < limit]
    runs = torch.unique_consecutive(kept, return_counts=True)[1]
    row = {"what": what, "n": limit, "M": int(slot.numel()),
           "kept": int(kept.numel()), "cols": cols,
           "dtype": str(src.dtype), "slot_dtype": str(slot.dtype),
           "slots": int(runs.numel()),
           "longest_run": int(runs.max()) if runs.numel() else 0,
           "tile_rows": seg_sum.tile_rows(cols, src.dtype),
           "long_runs": int((runs > seg_sum.tile_rows(cols, src.dtype))
                            .sum()),
           "max_abs_err": err, "calls_equal_cpu": SEG_REPEATS}
    if timed:
        # the launch as the route makes it: rows of one value read through
        # the permutation, wider rows copied out first
        row["reads"] = "permutation" if cols == 1 else "copied rows"
        row["ms"] = cuda_ms(
            (lambda: kernel.launch(out, slot, rows, perm, limit)) if cols == 1
            else (lambda: kernel.launch(out, slot, vals, None, limit)), 10)
        tgt = init.clone().to(device)
        row["wrapper_ms"] = cuda_ms(lambda: segments.index_add_float(
            tgt, idx_d, src_d, limit=limit), 5)
        row["library_ms"] = cuda_ms(
            lambda: tgt.index_add_(0, idx_d, src_d), 10)
        oc, sc, vc = out.cpu(), slot.cpu(), vals.cpu()
        t0 = time.perf_counter()
        seg_sum.seg_sum_plain(oc, sc, vc, limit=limit)
        row["plain_ms"] = (time.perf_counter() - t0) * 1e3
        row["add_ns"] = add_latency_ns(src.dtype)
        (row["bound_ms"], row["bound_by"], row["bytes_bound_ms"],
         row["chain_bound_ms"]) = seg_sum_bound(
            row["kept"], cols, row["slots"], src.element_size(),
            slot.element_size() + (8 if cols == 1 else 0),
            row["longest_run"], row["add_ns"])
        log(f"[kernel] seg_sum {what} (M={row['M']} rows of {cols}, "
            f"{row['kept']} kept on {row['slots']} slots, longest run "
            f"{row['longest_run']}, {row['long_runs']} runs over "
            f"{row['tile_rows']} rows): {row['ms']:.3f} ms reading "
            f"{row['reads']} (bound {row['bound_ms']:.6f} ms, by "
            f"{row['bound_by']}: bytes {row['bytes_bound_ms']:.6f} ms, "
            f"chain {row['chain_bound_ms']:.6f} ms), the route "
            f"{row['wrapper_ms']:.3f} ms, plain (CPU index_add_) "
            f"{row['plain_ms']:.3f} ms, index_add_ on the card "
            f"{row['library_ms']:.3f} ms")
    log(f"[kernel] seg_sum {what}: bit-equal to its plain version with "
        f"int32 and int64 slots, and the route to the CPU's index_add_ in "
        f"{SEG_REPEATS} calls")
    return row


def mixed_runs(rng, cols: int, dtype):
    """Scatter rows whose runs mix every length: 60,000 slots of 1-8
    rows, 2,000 of 50-500, 100 of 2,000-5,000 and 4 of 50,000, in a
    shuffled row order, with 10% of the rows dropped. Returns (index,
    values, limit) on the CPU."""
    import torch
    lens = np.concatenate([rng.integers(1, 9, 60_000),
                           rng.integers(50, 501, 2_000),
                           rng.integers(2_000, 5_001, 100),
                           np.full(4, 50_000)])
    n = len(lens)
    idx = np.repeat(rng.permutation(n), lens)
    idx[rng.random(len(idx)) < 0.1] = n
    idx = idx[rng.permutation(len(idx))]
    vals = rng.standard_normal((len(idx), cols)) * np.exp2(
        rng.integers(-40, 40, (len(idx), cols)))
    return (torch.from_numpy(idx),
            torch.from_numpy(vals if cols > 1 else vals[:, 0]).to(dtype), n)


def phase_seg_sum(device) -> dict:
    """Phase 2 for ``seg_sum``: synthetic scatters at the callers'
    shapes (a collision-heavy one, most rows on three slots; a uniform
    one; the corrector's (N, 21) quality sums; the paired estimators'
    float64 moments), one run of 1.2 million rows, and runs of mixed
    lengths at C = 21, each bit-equal to its plain version and the whole
    route to the CPU's ``index_add_``, each timed beside its byte and
    chain bounds."""
    import torch
    rng = np.random.default_rng(16)
    rows = []
    for what, n, M, cols, share, hot, dtype in (
            ("collision-heavy", 1000, 4_000_000, 1, 0.7, 3, torch.float32),
            ("uniform", 1 << 22, 1 << 24, 1, 0.0, 1, torch.float32),
            ("quality sums (N, 21)", 1 << 18, 1 << 20, 21, 0.1, 8,
             torch.float32),
            ("float64 moments (N, 3)", 1 << 16, 1 << 20, 3, 0.3, 5,
             torch.float64)):
        index, src = adversarial_rows(rng, n, M, cols, share, hot, dtype)
        rows.append(seg_sum_row(device, index, src, n, what, True))
    rng = np.random.default_rng(161)
    index, src = adversarial_rows(rng, 1000, 1_200_000, 1, 1.0, 1,
                                  torch.float32)
    rows.append(seg_sum_row(device, index, src, 1000, "one run", True))
    index, src, n = mixed_runs(rng, 21, torch.float32)
    rows.append(seg_sum_row(device, index, src, n,
                            "mixed run lengths (N, 21)", True))
    return {"rows": rows,
            "add_ns": {str(k): v for k, v in _CHAIN_NS.items()}}


@contextlib.contextmanager
def record_largest_float_sum():
    """While open, ``segments.index_add_float`` keeps the inputs of its
    largest call (by rows) on the card: yields a dict that then holds
    (out as it was, index, src, limit)."""
    from spades_for_blackbird_tpu_torch.ops import segments
    seen = {}
    original = segments.index_add_float

    def recording(out, index, src, limit=None):
        if out.is_cuda and index.numel() > seen.get("rows", -1):
            seen.update(rows=index.numel(), args=(
                out.clone(), index.clone(), src.clone(),
                out.shape[0] if limit is None else limit))
        return original(out, index, src, limit)
    segments.index_add_float = recording
    try:
        yield seen
    finally:
        segments.index_add_float = original


def main_path_sums(device, seen) -> dict:
    """The largest float sum of phase 4's assembly (condense's coverage
    sums) again: bit-equal to the CPU's ``index_add_`` in ``SEG_REPEATS``
    calls, the kernel to its plain version, timed."""
    out, index, src, limit = seen["args"]
    del seen["args"]
    if out.dim() != 1 or out.shape[0] != limit + 1 or out.abs().max() != 0:
        raise AssertionError("the largest float sum is not a drop_scatter")
    row = seg_sum_row(device, index.cpu(), src.cpu(), limit,
                      f"k={FULL_K} condense", timed=True)
    return row


def careful_again(device, card_dirs, cpu_dir, argv) -> list[dict]:
    """``--careful`` run on the card ``len(card_dirs)`` more times, each
    against the CPU's one run: the same contigs, scaffolds, paths and GFA
    segments, links and P-lines, bit for bit in the coverages too."""
    from spades_for_blackbird_tpu_torch import cli
    runs = []
    for out in card_dirs:
        t0 = time.perf_counter()
        rc = cli.main(argv + ["-o", out, "--device", str(device)])
        if rc != 0:
            raise AssertionError(f"--careful on the card returned {rc}")
        wall = time.perf_counter() - t0
        for name in ("contigs.fasta", "scaffolds.fasta", "contigs.paths",
                     "scaffolds.paths", "assembly_graph_with_scaffolds.gfa"):
            texts = [open(os.path.join(d, name)).read()
                     for d in (out, cpu_dir)]
            if texts[0] != texts[1]:
                raise AssertionError(f"--careful card run "
                                     f"{len(runs) + 2}: {name} differs "
                                     f"from the CPU's")
        runs.append({"gpu_s": wall})
        log(f"[gpu-vs-cpu] 20 kb careful, card run {len(runs) + 1} of "
            f"{CAREFUL_REPEATS}: byte-identical contigs, scaffolds, paths "
            f"and GFA to the CPU's; {wall:.2f} s")
    return runs


def sums_gpu_vs_cpu(device) -> dict:
    """Phase 3's float sums: ``drop_scatter`` on the card against the
    CPU's bits, ``SEG_REPEATS`` calls, on a collision-heavy scatter (most
    rows on a few slots, magnitudes of 2^-40 to 2^40)."""
    import torch
    from spades_for_blackbird_tpu_torch.ops import segments
    rng = np.random.default_rng(17)
    n = 5000
    index, src = adversarial_rows(rng, n, 2_000_000, 1, 0.9, 4,
                                  torch.float32)
    want = segments.drop_scatter(n, index, src)
    idx_d, src_d = index.to(device), src.to(device)
    for rep in range(SEG_REPEATS):
        if not float_bits_equal(segments.drop_scatter(n, idx_d, src_d),
                                want):
            raise AssertionError(f"drop_scatter's float sum on the card != "
                                 f"the CPU's on call {rep + 1}")
    atomic = torch.zeros(n + 1, device=device).index_add_(0, idx_d, src_d)
    differ = int((atomic[:n].cpu().view(torch.int32)
                  != want.view(torch.int32)).sum())
    log(f"[gpu-vs-cpu] drop_scatter float sum, 2,000,000 rows on {n} "
        f"slots (90% on 4): the CPU's bits in {SEG_REPEATS} calls (the "
        f"card's atomic index_add_ differs in {differ} slots)")
    return {"rows": 2_000_000, "slots": n, "calls": SEG_REPEATS,
            "atomic_slots_differing": differ}


_LOG_LINE = re.compile(r"^\d\d:\d\d:\d\d  [A-Z]+ \[.*\n", re.M)
_NUMBER = re.compile(r"-?\d+\.(\d+)")


def same_text(a: str, b: str) -> bool:
    """Two tool outputs agree: equal, or equal but for decimal numbers
    within one unit of their last printed digit (a float printed with d
    decimals is held to 10^-d)."""
    if a == b:
        return True
    ta, tb = re.split(r"(\s+|,)", a), re.split(r"(\s+|,)", b)
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        if x == y:
            continue
        mx, my = _NUMBER.fullmatch(x), _NUMBER.fullmatch(y)
        if not (mx and my and len(mx.group(1)) == len(my.group(1))):
            return False
        if abs(float(x) - float(y)) > 1.01 * 10.0 ** -len(mx.group(1)):
            return False
    return True


def tool_outputs(d: str) -> dict:
    """The files a tool wrote under ``d`` (gzip members decompressed, a
    save's archives left out), by relative path."""
    import gzip
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            rel = os.path.relpath(p, d)
            if "saves" in rel.split(os.sep) or n in (
                    "spades.log", "params.json", "spades_time_trace.json"):
                continue
            with open(p, "rb") as f:
                data = f.read()
            out[rel] = gzip.decompress(data) if n.endswith(".gz") else data
    return out


def cpu_tools(steps, root: str) -> dict:
    """Tools on the CPU in one child process, one after another
    (``cpu_tools_child``): {name: (rc, stdout, stderr, wall s)}. One
    process for several tools saves each its interpreter's start."""
    spec = os.path.join(root, f"cpu_tools_{steps[0][0]}.json")
    with open(spec, "w") as f:
        json.dump({"root": root, "steps": steps}, f)
    env = dict(os.environ, OMP_NUM_THREADS=str(CPU_RUN_THREADS))
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke, sys; "
         "chip_smoke.cpu_tools_child(sys.argv[1])", spec],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=CPU_RUN_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"the CPU's tools child failed:\n"
                             f"{proc.stderr[-3000:]}")
    with open(spec + ".out") as f:
        return {name: tuple(r) for name, r in json.load(f).items()}


def cpu_tools_child(spec_path: str) -> None:
    """The child of ``cpu_tools``: each step's tool through ``tools.main``
    with ``--device cpu``, its output captured, into root/<name>/cpu."""
    import io
    sys.path.insert(0, REPO)
    from spades_for_blackbird_tpu_torch import tools
    with open(spec_path) as f:
        spec = json.load(f)
    results = {}
    for name, argv, stdin in spec["steps"]:
        out = os.path.join(spec["root"], name, "cpu")
        os.makedirs(out, exist_ok=True)
        so, se = io.StringIO(), io.StringIO()
        sys.stdin = io.StringIO("" if stdin is None
                                else stdin.format(out=out))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            rc = tools.main([a.format(out=out) for a in argv]
                            + ["--device", "cpu"])
        results[name] = (rc, so.getvalue(), se.getvalue(),
                         time.perf_counter() - t0)
    with open(spec_path + ".out", "w") as f:
        json.dump(results, f)


def card_tool(device, argv, stdin: str | None = None):
    """A tool on the card in this process, its output captured, every
    kernel's count at 0 before it: (rc, stdout, stderr, wall s,
    {kernel: launches}, peak device bytes)."""
    import io
    import torch
    from spades_for_blackbird_tpu_torch import tools
    kernels = all_kernels()
    out, err = io.StringIO(), io.StringIO()
    saved_stdin = sys.stdin
    sys.stdin = io.StringIO(stdin or "")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = tools.main(list(argv) + ["--device", str(device)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sys.stdin = saved_stdin
    return (rc, out.getvalue(), err.getvalue(), wall,
            {n: k.launches for n, k in kernels.items()},
            torch.cuda.max_memory_allocated(device))


def tools_inputs(d: str, rng) -> dict:
    """Phase 3's inputs for the tools: a 20 kb genome with a repeat and a
    planted 150-residue domain, FR pairs at 40x with qualities (and the
    same reads in one file), noisy long reads, the domain's profile, a
    scaffold with an N run, contigs with two wrong bases, two barcodes'
    reads, a legacy save of the reads."""
    from spades_for_blackbird_tpu_torch import cli
    from spades_for_blackbird_tpu_torch.io import hmmfile
    from spades_for_blackbird_tpu_torch.ops import dna
    from spades_for_blackbird_tpu_torch.utils import simulate
    os.makedirs(d, exist_ok=True)
    genome = simulate.random_genome(TOOLS_GENOME, seed=5,
                                    repeats=[(400, 2)])
    dom = rng.integers(0, 20, 150).astype(np.uint8)
    g = dna.encode_str(genome)
    g[8000:8450] = reverse_translated(rng, dom)
    genome = dna.decode_codes(g)
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, 4000, read_len=100, insert_mean=300, insert_sd=25,
        error_rate=0.002, seed=6)
    p = {name: os.path.join(d, name) for name in (
        "r1.fq", "r2.fq", "all.fq", "genome.fa", "long.fa", "dom.hmm",
        "scaffolds.fa", "contigs.fa", "mag.fa", "bc", "save")}
    simulate.write_fastq(p["r1.fq"], r1, q1)
    simulate.write_fastq(p["r2.fq"], r2, q2)
    simulate.write_fastq(p["all.fq"], r1 + r2, q1 + q2)
    with open(p["genome.fa"], "w") as f:
        f.write(f">chr\n{genome}\n>part\n{genome[3000:9000]}\n")
    write_fasta_codes(p["long.fa"],
                      long_reads(rng, g, 1.0, (300, 900), 0.08)
                      + [rng.integers(0, 4, 800).astype(np.uint8)])
    hmmfile.write_hmm_file(p["dom.hmm"], hmm_profiles([dom]))
    with open(p["scaffolds.fa"], "w") as f:
        f.write(f">scf1\n{genome[1000:3000]}{'N' * 50}"
                f"{genome[3050:6000]}\n>scf2\n{genome[12000:15000]}\n")
    bad = dna.encode_str(genome[5000:9000])
    bad[[700, 2100]] = (bad[[700, 2100]] + 1) % 4
    with open(p["contigs.fa"], "w") as f:
        f.write(f">c1\n{dna.decode_codes(bad)}\n>c2\n{genome[:3000]}\n")
    with open(p["mag.fa"], "w") as f:
        f.write(f">m1\n{genome[2000:6000]}\n")
    os.makedirs(p["bc"])
    for name, lo in (("BC01", 0), ("BC02", 10_000)):
        part = genome[lo:lo + 3000]
        reads = [part[i:i + 100] for i in range(0, len(part) - 99, 10)]
        with open(os.path.join(p["bc"], f"{name}.fasta"), "w") as f:
            f.write("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    rc = cli.main(["-1", p["r1.fq"], "-2", p["r2.fq"], "-o", p["save"],
                   "--only-assembler", "-k", "21", "--checkpoints", "all",
                   "--stop-after", "read_conversion", "--device", "cpu"])
    if rc != 0:
        raise AssertionError("the tools' save run failed")
    return p


def tool_argvs(p: dict) -> list:
    """(name, argv with ``{out}`` for the output directory, stdin) of
    all 19 tools on phase 3's inputs; the graph tools read the GFA the
    card's gbuilder wrote."""
    gfa = os.path.join(p["card_gbuilder"], "g.gfa")
    return [
        ("gbuilder", ["gbuilder", p["all.fq"], "-k", "55", "--gfa",
                      "{out}/g.gfa", "--fastg", "{out}/g.fastg",
                      "--unitigs", "{out}/u.fasta"], None),
        ("kmercount", ["kmercount", p["all.fq"], "-k", "21", "-o",
                       "{out}/counts.tsv", "--min-count", "2"], None),
        ("kmer-estimating", ["kmer-estimating", p["all.fq"], "-k", "21"],
         None),
        ("read-filter", ["read-filter", p["all.fq"], "-k", "21",
                         "--min-coverage", "3", "-o", "{out}/kept.fa"],
         None),
        ("gsimplifier", ["gsimplifier", gfa, "{out}/simple.gfa"], None),
        ("gmapper", ["gmapper", gfa, p["long.fa"], "--output-dir",
                     "{out}/sp", "--output-format", "tsv,gpa,fasta"], None),
        ("kmer-multiplicity-counter", [
            "kmer-multiplicity-counter", p["r1.fq"], p["r2.fq"], "-k", "21",
            "-o", "{out}/prof.npz"], None),
        ("contig-abundance", ["contig-abundance", p["contigs.fa"],
                              os.path.join(p["card_counter"], "prof.npz"),
                              "-o", "{out}/abund.tsv", "--stat", "mean"],
         None),
        ("prop-binning", ["prop-binning", gfa, p["ann"], "-o",
                          "{out}/prop.ann", "--reads", p["r1.fq"],
                          "--reads-out-prefix", "{out}/binned"], None),
        ("vis", ["vis", gfa], "stats\nedges 5\nedge 0\nseq 1 0 30\n"
         "neigh 0 2\ndraw 0 2 {out}/n.dot\nhtml {out}/g.html\nquit\n"),
        ("scf-correction", ["scf-correction", gfa, p["scaffolds.fa"], "-o",
                            "{out}/scf.fa"], None),
        ("unitig-coverage", ["unitig-coverage", gfa, p["r1.fq"], p["r2.fq"],
                             "-o", "{out}/cov.tsv"], None),
        ("cds-subgraphs", ["cds-subgraphs", gfa, "--hmms", p["dom.hmm"],
                           "-o", "{out}/cds"], None),
        ("mag-improve", ["mag-improve", gfa, p["mag.fa"], "-o",
                         "{out}/mag.fa", "--radius", "2"], None),
        ("bin-converter", ["bin-converter", os.path.join(
            p["save"], "saves", "read_conversion"), "-o",
            "{out}/reads.fastq.gz"], None),
        ("corrector", ["corrector", p["contigs.fa"], p["r1.fq"], p["r2.fq"],
                       "-o", "{out}/fixed.fa"], None),
        ("truspades", ["truspades", "--input-dir", p["bc"], "-o", "{out}",
                       "-k", "21"], None),
        ("truseq-analysis", ["truseq-analysis", "--dataset", p["r1.fq"],
                             p["r2.fq"], "--genome", p["genome.fa"], "-k",
                             "55", "-o", "{out}/report"], None),
        ("edge-positions", ["edge-positions", gfa, p["genome.fa"], "-o",
                            "{out}/pos.tsv"], None),
    ]


def tools_gpu_vs_cpu(device) -> dict:
    """Phase 3 for the tools: each of the 19 on the card (in this
    process) and on the CPU (TOOLS_CPU_CHILDREN child processes, each
    running its share of the tools one after another) on
    a 20 kb genome: the same return code, the same files (gzip members
    decompressed) and the same standard output and error (the loggers'
    time-stamped lines and the output directory's path left out); a
    number printed with d decimals may differ by 10^-d."""
    from spades_for_blackbird_tpu_torch.graph.from_gfa import graph_from_gfa
    from spades_for_blackbird_tpu_torch.graph.host import host_view
    from spades_for_blackbird_tpu_torch.mts import binning
    from spades_for_blackbird_tpu_torch.ops import dna
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    record = {}
    try:
        p = tools_inputs(os.path.join(tmp, "in"), np.random.default_rng(18))
        # the graph tools read the card's GFA; contig-abundance the card's
        # profile; prop-binning an annotation of the GFA's segments
        steps = tool_argvs(dict(p, card_gbuilder="", card_counter="",
                                ann=""))
        # the graph: gbuilder's without the k-mers seen less than 3 times
        first = {name: argv for name, argv, _ in steps[:1] + steps[6:7]}
        first["gbuilder"] = first["gbuilder"][:4] + ["--min-count", "3"]
        for name, key in (("gbuilder", "card_gbuilder"),
                          ("kmer-multiplicity-counter", "card_counter")):
            p[key] = os.path.join(tmp, "in", name)
            os.makedirs(p[key])
            rc = card_tool(device, [a.format(out=p[key])
                                    for a in first[name]]
                           + ["--gfa", os.path.join(p[key], "g.gfa")]
                           * (name == "gbuilder"))
            if rc[0] != 0:
                raise AssertionError(f"{name} on the card returned {rc[0]}")
        g, names = graph_from_gfa(os.path.join(p["card_gbuilder"], "g.gfa"),
                                  return_names=True, device="cpu")
        hv = host_view(g)
        p["ann"] = os.path.join(tmp, "in", "bins.ann")
        binning.write_annotation(p["ann"], {
            name: ("BIN_A" if hv.seq_start[e] % 3 else "BIN_B")
            for e, name in names.items() if hv.seq_len[e] > 300})
        del g, hv
        steps = tool_argvs(p)
        with ThreadPoolExecutor(max_workers=TOOLS_CPU_CHILDREN) as pool:
            parts = [pool.submit(cpu_tools, steps[i::TOOLS_CPU_CHILDREN],
                                 tmp) for i in range(TOOLS_CPU_CHILDREN)]
            owner = {name: i % TOOLS_CPU_CHILDREN
                     for i, (name, _, _) in enumerate(steps)}
            for name, argv, stdin in steps:
                out = os.path.join(tmp, name, "cuda")
                os.makedirs(out)
                rc, so, se, wall, launches, peak = card_tool(
                    device, [a.format(out=out) for a in argv],
                    None if stdin is None else stdin.format(out=out))
                crc, cso, cse, cwall = parts[
                    owner[name]].result()[name]
                cpu_out = os.path.join(tmp, name, "cpu")
                if rc != 0 or crc != 0:
                    raise AssertionError(f"tool {name}: card returned {rc}, "
                                         f"CPU {crc}:\n{cse[-2000:]}")
                outs = [tool_outputs(d) for d in (out, cpu_out)]
                if sorted(outs[0]) != sorted(outs[1]):
                    raise AssertionError(f"tool {name}: the card and the "
                                         f"CPU wrote other files")
                for f in outs[0]:
                    a, b = outs[0][f], outs[1][f]
                    if a != b and not (f.endswith((".tsv", ".fa", ".fasta",
                                                   ".ann", ".gfa", ".dot",
                                                   ".html", "report"))
                                       and same_text(a.decode(),
                                                     b.decode())):
                        raise AssertionError(f"tool {name}: {f} differs "
                                             f"between card and CPU")
                texts = [(_LOG_LINE.sub("", x).replace(d, "<out>"))
                         for x, d in ((so + se, out), (cso + cse, cpu_out))]
                if not same_text(*texts):
                    raise AssertionError(f"tool {name}: its output differs "
                                         f"between card and CPU:\n"
                                         f"{texts[0][-1000:]}\n---\n"
                                         f"{texts[1][-1000:]}")
                record[name] = {"files": sorted(outs[0]), "gpu_s": wall,
                                "cpu_s": cwall, "launches": launches,
                                "peak_bytes": int(peak)}
                log(f"[gpu-vs-cpu] tool {name}: the same "
                    f"{len(outs[0])} files and output on card and CPU; "
                    f"card {wall:.2f} s ({launches}), cpu {cwall:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return record


def covered_share(lines: list[str], name: str, length: int) -> float:
    """The share of a sequence the ranges of an edge-positions dump
    cover (``name`` its FASTA name)."""
    cov = np.zeros(length + 1, np.int64)
    for line in lines:
        f = line.split("\t")
        if len(f) > 2 and f[1] == name:
            lo, hi = (int(x) for x in f[2].split("-"))
            cov[lo] += 1
            cov[min(hi, length)] -= 1
    return float((np.cumsum(cov[:length]) > 0).mean())


def phase_tools(device, tmp, inputs: dict) -> dict:
    """Phase 16 (``run_tools``) with the plain extraction refused on the
    card."""
    with plain_extraction_refused():
        return run_tools(device, tmp, inputs)


def run_tools(device, tmp, inputs: dict) -> dict:
    """Phase 16: the tools at full size, each through ``tools.main`` on
    the card with every kernel's count at 0 before it (wall, peak
    memory and launches printed): gbuilder -k 55 --min-count 3 on phase
    8's reads (without the floor the read errors leave a graph of short
    edges),
    then gsimplifier, unitig-coverage and edge-positions on its GFA
    (the ranges must cover POSITIONS_BAR of the genome); kmercount and
    kmer-estimating at k = 21 (within HLL_TOLERANCE of the distinct
    count); read-filter; gmapper with phase 15 (a)'s long reads on phase
    15 (b)'s GFA (the aligned share printed, no floor); scf-correction
    of phase 8's contigs with SCF_GAPS planted N runs (the gaps filled
    printed); cds-subgraphs with phase 15 (b)'s profiles; prop-binning
    (binning 1/BINNED_SHARE of the first mates),
    kmer-multiplicity-counter and contig-abundance on phase 12's
    community; then ``assemble_single_k`` with the max-flow EC remover
    on phase 10's uneven reads (genome fraction >= SC_FRACTION, no
    misassembly)."""
    import torch
    from spades_for_blackbird_tpu_torch.ops import dna
    from spades_for_blackbird_tpu_torch.pipeline import assemble
    from spades_for_blackbird_tpu_torch.simplify import runner
    from spades_for_blackbird_tpu_torch.utils import assess
    d = os.path.join(tmp, "tools")
    os.makedirs(d, exist_ok=True)
    genome = inputs["genome"]
    ref = os.path.join(d, "genome.fa")
    with open(ref, "w") as f:
        f.write(f">chr\n{genome}\n")
    runs, record = {}, {}
    t_phase = time.perf_counter()

    def run(name, argv, stdin=None):
        rc, so, se, wall, launches, peak = card_tool(device, argv, stdin)
        so, se = _LOG_LINE.sub("", so), _LOG_LINE.sub("", se)
        if rc != 0:
            raise AssertionError(f"tool {name} returned {rc}:\n"
                                 f"{(so + se)[-2000:]}")
        runs[name] = {"wall_s": wall, "launches": launches,
                      "peak_bytes": int(peak)}
        log(f"[tools] {name}: {wall:.2f} s, peak device memory "
            f"{peak / 2**30:.2f} GiB, launches {launches}")
        return so, se

    mates = inputs["mates"]
    gfa = os.path.join(d, "g.gfa")
    so, _ = run("gbuilder", ["gbuilder", *mates, "-k", str(TOOLS_K),
                             "--min-count", str(GBUILDER_MIN_COUNT),
                             "--gfa", gfa])
    log(f"[tools] gbuilder: {so.strip()}")
    run("gsimplifier", ["gsimplifier", gfa, os.path.join(d, "simple.gfa")])
    run("unitig-coverage", ["unitig-coverage", gfa, *mates, "-o",
                            os.path.join(d, "cov.tsv")])
    pos = os.path.join(d, "pos.tsv")
    run("edge-positions", ["edge-positions", gfa, ref, "-o", pos])
    with open(pos) as f:
        share = covered_share(f.read().splitlines(), "chr", len(genome))
    record["positions_share"] = share
    log(f"[tools] edge-positions: the ranges cover {share:.5f} of the "
        f"genome (bar {POSITIONS_BAR})")
    if share < POSITIONS_BAR:
        raise AssertionError(f"edge-positions covers {share:.5f} of the "
                             f"genome, under {POSITIONS_BAR}")
    _, se = run("kmercount", ["kmercount", *mates, "-k", str(KMERCOUNT_K),
                              "-o", os.path.join(d, "counts.tsv")])
    distinct = int(se.split()[0])
    os.remove(os.path.join(d, "counts.tsv"))
    so, _ = run("kmer-estimating", ["kmer-estimating", *mates, "-k",
                                    str(KMERCOUNT_K)])
    est = float(so.strip().splitlines()[-1])
    rel = est / distinct - 1.0
    record["hll"] = {"distinct": distinct, "estimate": est, "rel": rel}
    log(f"[tools] kmer-estimating {est:.0f} against kmercount's "
        f"{distinct} distinct {KMERCOUNT_K}-mers: {rel:+.4%} (bar "
        f"{HLL_TOLERANCE:.0%})")
    if abs(rel) > HLL_TOLERANCE:
        raise AssertionError(f"kmer-estimating is {rel:+.2%} off")
    _, se = run("read-filter", ["read-filter", *mates, "-k",
                                str(KMERCOUNT_K), "-o",
                                os.path.join(d, "kept.fa")])
    record["read_filter"] = se.strip().splitlines()[-1]
    os.remove(os.path.join(d, "kept.fa"))
    _, se = run("gmapper", ["gmapper", inputs["bio_gfa"],
                            inputs["long_reads"], "-o",
                            os.path.join(d, "al.tsv")])
    aligned, total = (int(x) for x in
                      se.strip().splitlines()[-1].split()[1].split("/"))
    record["gmapper_aligned"] = aligned / max(total, 1)
    log(f"[tools] gmapper: {aligned} of {total} long reads aligned "
        f"({aligned / max(total, 1):.4f}; no floor, ROADMAP Queue 3 "
        f"item 14)")
    # phase 8's contigs over 2 kb with a planted N run each
    contigs = [s for s, _ in read_fasta(inputs["contigs"]) if len(s) > 2000]
    scf = os.path.join(d, "scaffolds.fa")
    with open(scf, "w") as f:
        for i, s in enumerate(contigs[:SCF_GAPS]):
            mid = len(s) // 2
            f.write(f">s{i}\n{s[:mid]}{'N' * SCF_GAP_LEN}"
                    f"{s[mid + SCF_GAP_LEN:]}\n")
    fixed = os.path.join(d, "scf.fa")
    _, se = run("scf-correction", ["scf-correction", gfa, scf, "-o", fixed])
    filled = sum("N" not in s for _, s in fasta_records(fixed))
    record["scf_gaps"] = {"planted": min(SCF_GAPS, len(contigs)),
                          "filled": filled}
    log(f"[tools] scf-correction: {filled} of {min(SCF_GAPS, len(contigs))}"
        f" planted {SCF_GAP_LEN}-base N runs filled ({se.strip()})")
    _, se = run("cds-subgraphs", ["cds-subgraphs", inputs["bio_gfa"],
                                  "--hmms", inputs["hmms"], "-o",
                                  os.path.join(d, "cds")])
    record["cds"] = se.strip().splitlines()[-1]
    log(f"[tools] cds-subgraphs: {record['cds']}")
    meta = inputs["meta"]
    # a share of the first mates is binned: the gzip of every bin's
    # reads is most of the tool's time
    binned_in = os.path.join(d, "to_bin.fastq")
    with open(meta["mates"][0]) as src, open(binned_in, "w") as dst:
        n_lines = sum(1 for _ in src)
        src.seek(0)
        dst.writelines(line for i, line in zip(
            range(n_lines // 4 // BINNED_SHARE * 4), src))
    _, se = run("prop-binning", ["prop-binning", meta["gfa"], meta["ann"],
                                 "-o", os.path.join(d, "prop.ann"),
                                 "--reads", binned_in,
                                 "--reads-out-prefix",
                                 os.path.join(d, "binned")])
    record["prop_binning"] = [ln for ln in se.splitlines()
                              if ln.startswith("bin ")]
    prof = os.path.join(d, "prof.npz")
    run("kmer-multiplicity-counter", ["kmer-multiplicity-counter",
                                      *meta["mates"], "-k", "21", "-o", prof])
    run("contig-abundance", ["contig-abundance", meta["contigs"], prof,
                             "-o", os.path.join(d, "abund.tsv")])
    for f in os.listdir(d):
        if f.startswith("binned."):
            os.remove(os.path.join(d, f))

    # the max-flow EC remover on phase 10's uneven reads
    sc_genome = inputs["sc_genome"]
    codes = np.concatenate([load_codes(p) for p in inputs["sc_mates"]])
    lengths = np.full(codes.shape[0], FULL_READ_LEN, np.int32)
    kernels = all_kernels()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = assemble.assemble_single_k(
        codes, lengths, FULL_K, device=device,
        cfg=runner.SimplifyConfig(read_length=FULL_READ_LEN,
                                  mfec_enabled=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs["mfec_single_k"] = {
        "wall_s": wall, "launches": {n: k.launches
                                     for n, k in kernels.items()},
        "peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    rep = assess.assess([s for s, _ in res.contigs], sc_genome)
    record["mfec"] = rep.to_dict()
    log(f"[tools] assemble_single_k k={FULL_K} mfec_enabled=True on phase "
        f"10's uneven reads: {wall:.2f} s, launches "
        f"{runs['mfec_single_k']['launches']}; {rep.n_contigs} contigs, "
        f"genome fraction {rep.genome_fraction:.5f}, misassemblies "
        f"{rep.misassemblies}")
    if rep.genome_fraction < SC_FRACTION or rep.misassemblies != 0:
        raise AssertionError(f"mfec missed the --sc bar: {rep.to_dict()}")
    del res, codes
    record["runs"] = runs
    totals = {n: sum(r["launches"][n] for r in runs.values())
              for n in all_kernels()}
    log(f"[tools] launches over phase 16: {totals}")
    for name in ("kmer_extract", "viterbi", "seg_sum"):
        if totals[name] <= 0:
            raise AssertionError(f"phase 16 never launched {name}")
    if runs["cds-subgraphs"]["launches"]["viterbi"] <= 0:
        raise AssertionError("cds-subgraphs never launched viterbi")
    record["wall_s"] = time.perf_counter() - t_phase
    log(f"[tools] phase 16: {record['wall_s']:.1f} s (budget "
        f"{TOOLS_BUDGET_S:.0f} s)")
    shutil.rmtree(d, ignore_errors=True)
    return record


def load_codes(path: str) -> np.ndarray:
    from spades_for_blackbird_tpu_torch.io import fastq
    return fastq.load_reads(path).codes


def new_kernels():
    """{name: wrapper} of the hand kernels with no TPU counterpart."""
    from spades_for_blackbird_tpu_torch.ops import align, hmm
    return {"banded_ed": align.banded_edit_distance,
            "viterbi": hmm.viterbi_kernel}


def all_kernels():
    from spades_for_blackbird_tpu_torch.ops import kmer_cuda, seg_sum
    return dict(kmer_extract=kmer_cuda.extract_sort_keys, **new_kernels(),
                seg_sum=seg_sum.seg_sum)


def ed_bound(a_len, b_len, L: int, band: int):
    """(bound ms, what bounds it) of one banded edit distance call: the
    DP cells its pairs need (the band times each pair's columns) at
    ED_CELL_OPS integer operations, against the rows and lengths read
    once and the distances written once."""
    cells = (2 * band + 1) * int(np.minimum(b_len, L).sum())
    ops_ms = cells * ED_CELL_OPS / INT_OPS_PER_S * 1e3
    bytes_ms = (2 * len(a_len) * L + 12 * len(a_len)) / HBM_BYTES_PER_S \
        * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def viterbi_bound(lengths, ms, width=None):
    """(bound ms, what bounds it) of one Viterbi call of the profiles of
    lengths ``ms`` over rows of ``lengths``: the (position, node) steps
    at VITERBI_NODE_OPS float32 operations, against the rows (padded to
    ``width`` if given), their lengths and offsets and the profiles read
    once and the end scores and starts written once."""
    ms = np.atleast_1d(ms)
    lengths = np.asarray(lengths, np.int64)
    positions = len(lengths) * width if width else int(lengths.sum())
    steps = int(np.minimum(lengths, width or lengths.max(initial=0)).sum()) \
        * int(ms.sum())
    ops_ms = steps * VITERBI_NODE_OPS / FP32_OPS_PER_S * 1e3
    moved = positions + 12 * len(lengths) + 4 * 28 * int(ms.sum()) \
        + 8 * len(ms) * positions
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def ragged_rows(seqs, lengths, cut=None):
    """Padded rows (cut to their first ``cut`` positions) as one ragged
    buffer: (residues (N,) uint8, offsets (B,) int64, lengths (B,)
    int32)."""
    lengths = np.minimum(lengths, cut) if cut else np.asarray(lengths)
    flat = np.concatenate([seqs[b, :n] for b, n in enumerate(lengths)]
                          + [np.zeros(0, np.uint8)]).astype(np.uint8)
    lengths = lengths.astype(np.int64)
    return flat, np.cumsum(lengths) - lengths, lengths.astype(np.int32)


def viterbi_batch_vs_plain(device, profiles, flat, offsets, lengths,
                           compare) -> dict:
    """The batched kernel, every profile in one call, against the plain
    batched version of the profiles ``compare`` (indices) on the same
    ragged rows: raises unless end scores (their bits) and starts are
    equal everywhere. Returns the largest score difference (0.0) and
    the kernel's and the plain call's ms on these rows."""
    import torch
    from spades_for_blackbird_tpu_torch.ops import hmm
    pack = hmm.pack_profiles(profiles, device)
    sub = hmm.pack_profiles([profiles[i] for i in compare], device)
    s, o, ln = (torch.from_numpy(x).to(device)
                for x in (flat, offsets, lengths))
    es, st = hmm.viterbi_kernel.batched(pack, s, o, ln)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pes, pst = hmm.viterbi_batched_plain(sub, s, o, ln)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    idx = torch.tensor(list(compare), device=device)
    es, st = es[idx], st[idx]
    err = float((es - pes).abs().max()) if es.numel() else 0.0
    if not (torch.equal(es.view(torch.int32), pes.view(torch.int32))
            and torch.equal(st, pst)):
        raise AssertionError(
            f"batched viterbi kernel != plain for profiles of "
            f"{[profiles[i].length for i in compare]} nodes over "
            f"{len(lengths)} rows")
    kernel_ms = cuda_ms(lambda: hmm.viterbi_kernel.batched(pack, s, o, ln),
                        2)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms}


def padded_as_ragged(seqs, lengths):
    """A padded (B, L) array as ragged rows: (residues (B * L,), offsets
    r * L, lengths), what the one-profile call hands the kernel."""
    B, L = seqs.shape
    return (np.ascontiguousarray(seqs).reshape(-1),
            np.arange(B, dtype=np.int64) * L,
            np.minimum(lengths, L).astype(np.int32))


def viterbi_batch_launch_ms(device, profiles, flat, offsets, lengths,
                            reps: int) -> float:
    """CUDA-event ms of the bare batched launch (outputs allocated once)
    of every profile over the ragged rows."""
    import torch
    from spades_for_blackbird_tpu_torch.ops import hmm
    pack = hmm.pack_profiles(profiles, device)
    s = hmm._aligned(torch.from_numpy(flat).to(device))
    o, ln = (torch.from_numpy(x).to(device) for x in (offsets, lengths))
    es = torch.empty((len(profiles), len(flat)), dtype=torch.float32,
                     device=device)
    st = torch.empty_like(es, dtype=torch.int32)
    order = hmm._longest_first(ln)
    ms = cuda_ms(lambda: hmm.viterbi_kernel.launch_batched(
        pack, s, o, ln, order, es, st), reps)
    del es, st
    torch.cuda.empty_cache()
    return ms


def ed_pairs(rng, B: int, L: int, band: int, ragged: bool):
    """Pairs as the hybrid stages hand them over: a fill against a second
    read's fill (10% substitutions), all of width L; ``ragged`` adds
    lengths 0 and 1 and length differences past the band."""
    a = rng.integers(0, 4, (B, L)).astype(np.uint8)
    b = np.where(rng.random((B, L)) < 0.1, rng.integers(0, 4, (B, L)),
                 a).astype(np.uint8)
    a_len = np.full(B, L, np.int32)
    b_len = np.full(B, L, np.int32)
    if ragged:
        a_len = rng.integers(0, L + 1, B).astype(np.int32)
        b_len = np.clip(a_len + rng.integers(-2 * band, 2 * band + 1, B),
                        0, L).astype(np.int32)
        a_len[0], b_len[0] = 0, min(L, 5)
        if B > 1:
            a_len[1], b_len[1] = min(L, 1), 0
        if B > 2:
            a_len[2], b_len[2] = L, max(L - band - 7, 0)
    for x, n in ((a, a_len), (b, b_len)):
        x[np.arange(L)[None, :] >= n[:, None]] = 4
    return a, a_len, b, b_len


def viterbi_rows_vs_plain(device, profile, seqs, lengths, cut=None) -> float:
    """The kernel against its plain version on the same rows (cut to
    their first ``cut`` positions): the largest end-score difference at
    positions within each row's length (0.0: bit-equal); raises unless
    the scores and starts there are bit-equal."""
    import torch
    from spades_for_blackbird_tpu_torch.ops import hmm
    if cut is not None:
        seqs = seqs[:, :cut]
        lengths = np.minimum(lengths, cut)
    args = hmm.profile_tensors(profile, device)
    s = torch.from_numpy(np.ascontiguousarray(seqs)).to(device)
    ln = torch.from_numpy(np.ascontiguousarray(lengths)).to(device)
    es, st = hmm.viterbi_kernel(*args, s, ln, profile.length)
    pes, pst = hmm.viterbi_ends_plain(*args, s, ln, profile.length)
    torch.cuda.synchronize()
    inside = (torch.arange(s.shape[1], device=device)[None, :]
              < ln[:, None])
    err = float(torch.where(inside, (es - pes).abs(), 0).max()) \
        if s.numel() else 0.0
    if err != 0.0 or not bool(((st == pst) | ~inside).all()):
        raise AssertionError(f"viterbi kernel != plain at m="
                             f"{profile.length}, rows {tuple(s.shape)}")
    return err


def consensus_rows(rng, cons, B: int, L: int):
    """AA rows with a mutated copy of ``cons`` planted in each, ragged
    lengths (0 and 1 included) and stop codons."""
    seqs = rng.integers(0, 21, (B, L)).astype(np.uint8)
    m = len(cons)
    for b in range(B):
        at = int(rng.integers(0, max(1, L - m)))
        copy = np.where(rng.random(m) < 0.1, rng.integers(0, 20, m), cons)
        seqs[b, at:at + m] = copy[:L - at]
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:3] = (0, 1, L)
    return seqs, lengths


def phase_new_kernels(device) -> dict:
    """Phase 2 for the hand kernels with no TPU counterpart: banded_ed
    at the hybrid stages' shapes (B = 1-8, L up to 2,000, band 48) and
    ragged ones, and ragged pairs at every slot-a-lane width (bands
    ED_BANDS), bit-equal to its plain version; viterbi at profile lengths
    120 and 300 (the timed shape), 512 (the warp path's largest),
    1,100 and 2,048 (the block path), bit-equal within each row's length,
    and the batched shape: 12 profiles of 135-294 nodes over 12 ragged
    rows in one call, bit-equal everywhere; past the block path, 2,049,
    4,000 and 5,000 nodes (the tile path) beside 2,048, bit-equal within
    each row's length, 2,048 and 4,000 timed a position. CUDA events
    time the bare launches beside the bound and the plain versions."""
    import torch
    from spades_for_blackbird_tpu_torch.ops import align, hmm
    rng = np.random.default_rng(15)
    ed = align.banded_edit_distance
    ed_rows = []
    shapes = [(1, 2000, False, ED_BAND), (8, 2000, False, ED_BAND),
              (8, 2000, True, ED_BAND), (5, 600, True, ED_BAND),
              (3, 1, False, ED_BAND), (2, 300, True, ED_BAND)]
    shapes += [(8, 600, True, band) for band in ED_BANDS if band != ED_BAND]
    for B, L, ragged, band in shapes:
        a, al, b, bl = (torch.from_numpy(x).to(device)
                        for x in ed_pairs(rng, B, L, band, ragged))
        got = ed(a, al, b, bl, band)
        want = align.banded_edit_distance_plain(a, al, b, bl, band)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        row = {"B": B, "L": L, "band": band, "ragged": ragged,
               "max_abs_err": err}
        if err != 0.0:
            raise AssertionError(f"banded_ed kernel != plain at {row}")
        if (B, L, ragged) == (8, 2000, False):
            out = torch.empty(B, dtype=torch.int32, device=device)
            row["ms"] = cuda_ms(lambda: ed.launch(a, al, b, bl, band,
                                                  out), 20)
            row["plain_ms"] = cuda_ms(
                lambda: align.banded_edit_distance_plain(a, al, b, bl,
                                                         band), 2)
            row["bound_ms"], row["bound_by"] = ed_bound(
                al.cpu().numpy(), bl.cpu().numpy(), L, band)
            log(f"[kernel] banded_ed B={B} L={L} band={band}: "
                f"{row['ms']:.3f} ms (bound {row['bound_ms']:.6f} ms, by "
                f"{row['bound_by']}), plain {row['plain_ms']:.3f} ms")
        log(f"[kernel] banded_ed B={B} L={L} band={band} ragged={ragged}: "
            f"max_abs_err={err}")
        ed_rows.append(row)
    vit_rows = []
    for m, B, L in ((120, 12, 3000), (300, 12, 3000), (512, 4, 800),
                    (1100, 4, 800), (2048, 3, 600)):
        cons = rng.integers(0, 20, m).astype(np.uint8)
        profile = hmm.hmm_from_consensus(f"c{m}", cons)
        seqs, lengths = consensus_rows(rng, cons, B, L)
        err = viterbi_rows_vs_plain(device, profile, seqs, lengths)
        row = {"m": m, "B": B, "L": L, "max_abs_err": err}
        if m == 300:
            args = hmm.profile_tensors(profile, device)
            s = torch.from_numpy(seqs).to(device)
            ln = torch.from_numpy(lengths).to(device)
            row["ms"] = viterbi_batch_launch_ms(
                device, [profile], *padded_as_ragged(seqs, lengths), 5)
            row["plain_ms"] = cuda_ms(
                lambda: hmm.viterbi_ends_plain(*args, s, ln, m), 1)
            row["bound_ms"], row["bound_by"] = viterbi_bound(lengths, m, L)
            log(f"[kernel] viterbi m={m} B={B} L={L}: {row['ms']:.3f} ms "
                f"(bound {row['bound_ms']:.6f} ms, by {row['bound_by']}), "
                f"plain {row['plain_ms']:.3f} ms")
        log(f"[kernel] viterbi m={m} B={B} L={L}: max_abs_err={err}")
        vit_rows.append(row)
    # past the block path: m > 2,048 takes the tile path (node tiles of
    # 2,048); the block path's largest m beside it, both timed a position
    # (the launch lasts as long as the longest row, L positions)
    rng_long = np.random.default_rng(151)
    for m, B, L in VITERBI_LONG_CASES:
        cons = rng_long.integers(0, 20, m).astype(np.uint8)
        profile = hmm.hmm_from_consensus(f"c{m}", cons)
        seqs, lengths = consensus_rows(rng_long, cons, B, L)
        err = viterbi_rows_vs_plain(device, profile, seqs, lengths)
        row = {"m": m, "B": B, "L": L, "max_abs_err": err,
               "path": "tile" if m > hmm.BLOCK_MAX_M else "block"}
        if m in VITERBI_TIMED_M:
            row["ms"] = viterbi_batch_launch_ms(
                device, [profile], *padded_as_ragged(seqs, lengths), 3)
            row["us_a_position"] = row["ms"] * 1e3 / L
            row["bound_ms"], row["bound_by"] = viterbi_bound(lengths, m, L)
            log(f"[kernel] viterbi m={m} ({row['path']} path) B={B} L={L}: "
                f"{row['ms']:.3f} ms, {row['us_a_position']:.3f} us a "
                f"position (bound {row['bound_ms']:.6f} ms, by "
                f"{row['bound_by']})")
        log(f"[kernel] viterbi m={m} ({row['path']} path) B={B} L={L}: "
            f"max_abs_err={err}")
        vit_rows.append(row)
    # the batched shape: every profile in one call over ragged rows
    ms = np.linspace(*VITERBI_BATCH_M, 12).astype(int)
    profiles = [hmm.hmm_from_consensus(f"b{m}", rng.integers(0, 20, m))
                for m in ms]
    seqs, lengths = consensus_rows(
        rng, np.asarray(profiles[0].match[:, :20].argmax(1), np.uint8),
        12, 3000)
    cut = viterbi_batch_vs_plain(
        device, profiles, *ragged_rows(seqs, lengths, VITERBI_BATCH_CUT),
        compare=range(len(profiles)))
    rows = ragged_rows(seqs, lengths)
    batch = {"profiles": len(profiles), "m": [int(m) for m in ms],
             "B": len(lengths), "L": int(lengths.max()),
             "positions": int(lengths.sum()),
             "max_abs_err": cut["max_abs_err"],
             "ms": viterbi_batch_launch_ms(device, profiles, *rows, 5),
             "cut": dict(cut, L=VITERBI_BATCH_CUT)}
    batch["bound_ms"], batch["bound_by"] = viterbi_bound(lengths, ms)
    log(f"[kernel] viterbi batched, {len(profiles)} profiles of "
        f"{ms.min()}-{ms.max()} nodes, {len(lengths)} ragged rows (up to "
        f"{batch['L']} positions): {batch['ms']:.3f} ms a launch (bound "
        f"{batch['bound_ms']:.6f} ms, by {batch['bound_by']}); cut to "
        f"{VITERBI_BATCH_CUT} positions {cut['ms']:.3f} ms, plain "
        f"{cut['plain_ms']:.3f} ms, bit-equal for every profile")
    return {"banded_ed": ed_rows, "viterbi": vit_rows,
            "viterbi_batched": batch}


def noisy_codes(rng, codes, rate: float) -> np.ndarray:
    """The JAX tests' ``noisy``: each base deleted, substituted by a
    random base, or followed by an inserted random base, each with
    probability rate / 3."""
    r = rng.random(len(codes))
    keep = r >= rate / 3
    sub = keep & (r < 2 * rate / 3)
    ins = (r >= 2 * rate / 3) & (r < rate)
    base = np.where(sub, rng.integers(0, 4, len(codes)), codes)
    counts = keep.astype(np.int64) + ins
    out = np.repeat(base.astype(np.uint8), counts)
    at = np.cumsum(counts)[ins] - 1
    out[at] = rng.integers(0, 4, len(at))
    return out


def long_reads(rng, g, coverage: float, lengths, rate: float):
    """Noisy long reads of the codes ``g``: lengths uniform in
    ``lengths``, anywhere on either strand, until ``coverage``."""
    reads, total = [], 0
    while total < coverage * len(g):
        n = int(rng.integers(lengths[0], lengths[1] + 1))
        at = int(rng.integers(0, len(g) - n + 1))
        r = g[at:at + n]
        if rng.random() < 0.5:
            r = 3 - r[::-1]
        reads.append(noisy_codes(rng, r, rate))
        total += n
    return reads


def write_fasta_codes(path: str, reads) -> None:
    from spades_for_blackbird_tpu_torch.ops import dna
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b">lr_%d\n%s\n" % (i, dna.CODE_TO_CHAR[r].tobytes()))


def reverse_translated(rng, aa_codes) -> np.ndarray:
    """DNA codes of an AA sequence, a random synonymous codon a residue
    (so no two copies of a domain share long exact stretches)."""
    from spades_for_blackbird_tpu_torch.ops import aa
    base = {"A": 0, "C": 1, "G": 2, "T": 3}
    codons = [[] for _ in range(aa.NUM_AA)]
    for codon, res in aa._CODON_TABLE_STR.items():
        if res != "*":
            codons[aa.AA_CODE[res]].append([base[c] for c in codon])
    pick = [codons[a][int(rng.integers(len(codons[a])))] for a in aa_codes]
    return np.asarray(pick, np.uint8).reshape(-1)


def repeated_positions(g) -> np.ndarray:
    """(len(g),) bool: inside a canonical 21-mer seen twice or more."""
    km = packed_kmers(g)
    _, inv, cnt = np.unique(km, return_inverse=True, return_counts=True)
    dup = (cnt[inv] > 1).astype(np.int64)
    edge = np.zeros(len(g) + 1, np.int64)
    np.add.at(edge, np.nonzero(dup)[0], 1)
    np.add.at(edge, np.nonzero(dup)[0] + 21, -1)
    return np.cumsum(edge)[:len(g)] > 0


def hybrid_genome(size: int = FULL_GENOME, n_clusters: int = CLUSTERS):
    """Phase 15's genome: phase 8's (seed 7, its planted repeats; at
    another ``size`` the same simulation cut) with ``n_clusters``
    clusters of 3-5 domains planted in every fourth of 32 slots, and
    HYBRID_HOLES holes of 400-1,000 bases in the other slots, each at
    least 2 kb from a repeated 21-mer. Returns (genome, codes, the
    domains' AA codes, clusters as (start, end, [domain names]), holes
    as (start, end))."""
    from spades_for_blackbird_tpu_torch.ops import dna
    from spades_for_blackbird_tpu_torch.utils import simulate
    g = dna.encode_str(simulate.random_genome(
        size, seed=7, repeats=[(2000, 3), (700, 4), (400, 6)])).copy()
    rng = np.random.default_rng(150)
    repeated = repeated_positions(g)

    def clear(lo, hi):
        return not repeated[max(lo - 2000, 0):hi + 2000].any()
    domains = [rng.integers(0, 20, int(rng.integers(DOMAIN_AA[0],
                                                    DOMAIN_AA[1] + 1)))
               for _ in range(DOMAINS)]
    slot = size // 32
    clusters = []
    for c in range(n_clusters):
        ids = rng.choice(DOMAINS, int(rng.integers(CLUSTER_DOMAINS[0],
                                                   CLUSTER_DOMAINS[1] + 1)),
                         replace=False)
        pieces = [reverse_translated(rng, domains[i]) for i in ids]
        gaps = list(rng.integers(CLUSTER_GAP[0], CLUSTER_GAP[1] + 1,
                                 len(ids) - 1)) + [0]
        span = sum(map(len, pieces)) + sum(gaps)
        lo = 4 * c * slot + 10_000
        while not clear(lo, lo + span):
            lo += 5_000
        at = lo
        for piece, gap in zip(pieces, gaps):
            g[at:at + len(piece)] = piece
            at += len(piece) + int(gap)
        clusters.append((lo, at, [f"dom{i:02d}" for i in ids]))
    holes = []
    for s in range(32):
        if s % 4 == 0:
            continue
        n = int(rng.integers(HOLE_LEN[0], HOLE_LEN[1] + 1))
        lo = s * slot + slot // 2
        while not clear(lo, lo + n):
            lo += 5_000
        holes.append((lo, lo + n))
    return dna.decode_codes(g), g, domains, clusters, holes


def mates_in_holes(start, ins, holes) -> np.ndarray:
    """(n_pairs,) bool: a mate of the pair (fragment ``start``, length
    ``ins``, reads of FULL_READ_LEN) overlaps one of the sorted,
    disjoint ``holes``."""
    hs = np.asarray([h[0] for h in holes])
    he = np.asarray([h[1] for h in holes])
    hit = np.zeros(len(start), bool)
    for lo in (start, start + ins - FULL_READ_LEN):
        j = np.searchsorted(he, lo, side="right")
        ok = j < len(hs)
        hit |= ok & (hs[np.minimum(j, len(hs) - 1)] < lo + FULL_READ_LEN)
    return hit


def hybrid_pairs(rng, g, holes):
    """FR pairs at FULL_COVERAGE over the linear codes ``g`` with errors
    and qualities: (codes1, quals1, codes2, quals2, in_hole mask)."""
    rl = FULL_READ_LEN
    n_pairs = int(FULL_COVERAGE * len(g) / (2 * rl))
    ins = np.clip(rng.normal(300.0, 25.0, n_pairs).astype(np.int64), rl,
                  len(g))
    start = (rng.random(n_pairs) * (len(g) - ins + 1)).astype(np.int64)
    offs = np.arange(rl)
    r1 = g[start[:, None] + offs]
    r2 = 3 - g[(start + ins - rl)[:, None] + offs][:, ::-1]
    flip = rng.random(n_pairs) < 0.5
    r1, r2 = (np.where(flip[:, None], 3 - r2[:, ::-1], r1),
              np.where(flip[:, None], 3 - r1[:, ::-1], r2))
    c1, q1 = with_errors(rng, r1.astype(np.uint8))
    c2, q2 = with_errors(rng, r2.astype(np.uint8))
    return c1, q1, c2, q2, mates_in_holes(start, ins, holes)


@contextlib.contextmanager
def launches_of_stages(kernels: dict):
    """While open, every stage list the command line builds counts the
    launches of each of ``kernels`` inside each stage: yields {stage
    name: {kernel name: launches}}."""
    import dataclasses as dc
    from spades_for_blackbird_tpu_torch.pipeline import spades_stages
    counts: dict[str, dict[str, int]] = {}
    build = spades_stages.build_stage_list

    def counted(stage):
        def fn(ctx):
            before = {n: k.launches for n, k in kernels.items()}
            try:
                return stage.fn(ctx)
            finally:
                mine = counts.setdefault(stage.name, {})
                for n, k in kernels.items():
                    mine[n] = mine.get(n, 0) + k.launches - before[n]
        return dc.replace(stage, fn=fn)

    def wrapped(*args, **kwargs):
        return [counted(s) for s in build(*args, **kwargs)]
    spades_stages.build_stage_list = wrapped
    try:
        yield counts
    finally:
        spades_stages.build_stage_list = build


def counted_cli(device, argv):
    """``cli.main(argv)`` with every kernel's count at 0 before it:
    (wall s, {kernel: launches}, {stage: {kernel: launches}}, peak device
    bytes); raises unless it returns 0."""
    import torch
    from spades_for_blackbird_tpu_torch import cli
    kernels = all_kernels()
    with launches_of_stages(kernels) as by_stage:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}
    if rc != 0:
        raise AssertionError(f"cli.main {' '.join(argv)} returned {rc}")
    return wall, launches, dict(by_stage), \
        torch.cuda.max_memory_allocated(device)


def hmm_profiles(domains):
    from spades_for_blackbird_tpu_torch.ops import hmm
    return [hmm.hmm_from_consensus(f"dom{i:02d}", d)
            for i, d in enumerate(domains)]


def hybrid_modes_gpu_vs_cpu(device) -> dict:
    """Phase 3 for the hybrid, HMM and series command lines, each on the
    card and on the CPU at -k 21 --only-assembler --checkpoints none:
    ``-1/-2 --pacbio`` and ``--sanger`` (FR pairs of a 12 kb genome
    with a 600 bp hole, ten noisy long reads across it), ``--bio
    --custom-hmms`` and ``--corona --custom-hmms`` (all the pairs; two
    domains planted 800 bases apart) and ``--series-analysis`` (a
    two-sample profile: the pairs and a third of them): identical
    FASTA, ``.paths``, ``final.lib_data``, GFA and HMM files, and
    identical series files."""
    from spades_for_blackbird_tpu_torch.io import hmmfile
    from spades_for_blackbird_tpu_torch.mts import abundance
    from spades_for_blackbird_tpu_torch.ops import dna
    from spades_for_blackbird_tpu_torch.utils import simulate
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hybrid_")
    rng = np.random.default_rng(16)
    record = {}
    try:
        g = dna.encode_str(simulate.random_genome(HYBRID_3_GENOME,
                                                  seed=17)).copy()
        domains = [rng.integers(0, 20, 150), rng.integers(0, 20, 200)]
        at = 3_000
        for d in domains:
            piece = reverse_translated(rng, d)
            g[at:at + len(piece)] = piece
            at += len(piece) + 800
        hole = [(8_000, 8_600)]
        c1, q1, c2, q2, in_hole = hybrid_pairs(rng, g, hole)
        full = [os.path.join(tmp, f"all_{m}.fastq") for m in (1, 2)]
        holed = [os.path.join(tmp, f"holed_{m}.fastq") for m in (1, 2)]
        for path, c, q in zip(full, (c1, c2), (q1, q2)):
            write_fastq(path, c, q)
        for path, c, q in zip(holed, (c1, c2), (q1, q2)):
            write_fastq(path, c[~in_hole], q[~in_hole])
        lr = os.path.join(tmp, "long.fasta")
        write_fasta_codes(lr, [noisy_codes(rng, g[lo:lo + 3000], LONG_ERROR)
                               for lo in range(6_800, 7_300, 50)])
        hmm_path = os.path.join(tmp, "models.hmm")
        hmmfile.write_hmm_file(hmm_path, hmm_profiles(domains))
        both = np.concatenate([c1, c2])
        lens = np.full(len(both), FULL_READ_LEN, np.int32)
        abundance.save_profiles(os.path.join(tmp, "prof.npz"), *abundance.
                                multiplicity_profiles(
                                    [(both, lens), (both[::3], lens[::3])],
                                    SERIES_K, device=device), SERIES_K)
        for dev in (str(device), "cpu"):
            with open(os.path.join(tmp, f"series_{dev}.yaml"), "w") as f:
                f.write(f"kmer_mult: {tmp}/prof.npz\nfrag_size: 200\n"
                        + "".join(f"{key}: {tmp}/{dev}_{key}\n" for key in (
                            "edges_sqn", "edges_mpl", "edge_fragments_mpl")))
        runs = (("pacbio", holed, ["--pacbio", lr]),
                ("sanger", holed, ["--sanger", lr]),
                ("bio", full, ["--bio", "--custom-hmms", hmm_path]),
                ("corona", full, ["--corona", "--custom-hmms", hmm_path]),
                ("series", full, ["--series-analysis",
                                  os.path.join(tmp, "series_{dev}.yaml")]))
        argvs = {name: ["-1", m1, "-2", m2, "-k", "21", "--only-assembler",
                        "--checkpoints", "none"] + flags
                 for name, (m1, m2), flags in runs}
        with CardAndCpu(device, tmp) as both:
            for name, argv in argvs.items():
                both.submit(name, argv)
            done = {name: both.run(name, argv)
                    for name, argv in argvs.items()}
        for name, _, flags in runs:
            walls, (card, cpu) = done[name]
            files, sa, pa = compare_outputs(card, cpu, name)
            if name == "series":
                for key in ("edges_sqn", "edges_mpl", "edge_fragments_mpl"):
                    texts = [open(os.path.join(tmp, f"{d}_{key}")).read()
                             for d in (str(device), "cpu")]
                    if texts[0] != texts[1] or not texts[0]:
                        raise AssertionError(f"series {key} differs")
                    files.append(key)
            lines = log_lines(card, ["hybrid gap closing", "domain hits",
                                     "domain graph", "series analysis"])
            record[name] = {"files": files, "segments": len(sa),
                            "paths": len(pa), "gpu_s": walls[str(device)],
                            "cpu_s": walls["cpu"], "log": lines}
            log(f"[gpu-vs-cpu] {HYBRID_3_GENOME // 1000} kb "
                f"{' '.join(flags[:1])}: {len(sa)} "
                f"segments, identical {', '.join(files)}; {lines}; card "
                f"{walls[str(device)]:.2f} s, cpu {walls['cpu']:.2f} s")
        if "1 joins" not in " ".join(record["pacbio"]["log"]):
            raise AssertionError("--pacbio at 20 kb did not close the hole")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return record


def spans_hole(seqs, genome: str, hole) -> bool:
    """One of ``seqs`` holds both 100-mers 50 bases outside the hole, on
    one strand."""
    from spades_for_blackbird_tpu_torch.ops import dna
    lo, hi = hole
    left, right = genome[lo - 150:lo - 50], genome[hi + 50:hi + 150]
    pairs = ((left, right), (dna.revcomp_str(right), dna.revcomp_str(left)))
    return any(a in s and b in s for s in seqs for a, b in pairs)


def touches_hole(seq: str, genome: str, holes) -> bool:
    from spades_for_blackbird_tpu_torch.ops import dna
    for lo, hi in holes:
        for flank in (genome[lo - 150:lo - 50], genome[hi + 50:hi + 150]):
            if flank in seq or dna.revcomp_str(flank) in seq:
                return True
    return False


def hybrid_reads(tmp, g, holes, rng, name: str):
    """Phase 15's reads of the codes ``g``: the FR pairs with qualities,
    all (``<name>_[12].fastq``) and without the pairs that have a mate in
    a hole (``<name>_holed_[12].fastq``), and the long reads
    (``<name>_long.fasta``). Returns (all, holed, long-read path, pairs,
    pairs kept, long reads, their bases)."""
    c1, q1, c2, q2, in_hole = hybrid_pairs(rng, g, holes)
    full = [os.path.join(tmp, f"{name}_{m}.fastq") for m in (1, 2)]
    holed = [os.path.join(tmp, f"{name}_holed_{m}.fastq") for m in (1, 2)]
    for path, c, q in zip(full, (c1, c2), (q1, q2)):
        write_fastq(path, c, q)
    for path, c, q in zip(holed, (c1, c2), (q1, q2)):
        write_fastq(path, c[~in_hole], q[~in_hole])
    lrs = long_reads(rng, g, LONG_COVERAGE, LONG_LEN, LONG_ERROR)
    lr_path = os.path.join(tmp, f"{name}_long.fasta")
    write_fasta_codes(lr_path, lrs)
    return (full, holed, lr_path, len(in_hole), int((~in_hole).sum()),
            len(lrs), sum(map(len, lrs)))


def nanopore_run(device, tmp, genome, holes, holed, lr_path, bar: float,
                 label: str = "nanopore", extra=()) -> dict:
    """``-1/-2 --nanopore`` on the holed pairs and the long reads: the
    wall, peak memory, each kernel's launches by stage, the joins of
    each hybrid stage, and for contigs and N-stripped scaffolds the
    quality, the misassemblies outside the holes and the holes one
    record spans; the quality bar, and at least ``bar`` of the holes
    spanned."""
    from spades_for_blackbird_tpu_torch.utils import assess
    out = os.path.join(tmp, label)
    argv = ["-1", holed[0], "-2", holed[1], "--nanopore", lr_path, "-o", out,
            "--checkpoints", "none", "--trace-time", *extra]
    with plain_extraction_refused():
        wall, launches, by_stage, peak = counted_cli(device, argv)
    stages, spans = stage_seconds(out, [
        "read_conversion", "error_correction", "k21", "k33", "k55",
        "gap_closing", "hybrid_aligning", "hybrid_aligning_2",
        "repeat_resolution", "contig_output"])
    with open(os.path.join(out, "spades.log")) as f:
        joins = [int(x) for x in re.findall(
            r"hybrid gap closing: (\d+) joins", f.read())]
    rec = {"genome": len(genome), "wall_s": wall, "launches": launches,
           "by_stage": by_stage, "peak_bytes": peak, "stages_s": stages,
           "rr_align_long_reads_s": spans.get("rr_align_long_reads", 0.0),
           "joins": joins}
    for name in ("contigs", "scaffolds"):
        seqs = [s for s, _ in read_fasta(os.path.join(out, f"{name}.fasta"))]
        rep = assess.assess([s.replace("N", "") for s in seqs], genome)
        near = [touches_hole(s, genome, holes) for s in seqs]
        outside = sum(pc.get("misassemblies", 0)
                      for pc, n in zip(rep.per_contig, near) if not n)
        spanned = sum(spans_hole(seqs, genome, h) for h in holes)
        rec[name] = dict(rep.to_dict(), misassemblies_outside_holes=outside,
                         holes_spanned=spanned)
        rec[name].pop("per_contig", None)
        log(f"[hybrid] {label} {name}: {rep.n_contigs} records, NG50 "
            f"{rep.ng50}, genome fraction {rep.genome_fraction:.5f}, "
            f"misassemblies {rep.misassemblies} ({outside} outside the "
            f"holes), holes spanned by one record {spanned} of "
            f"{len(holes)}")
    log(f"[hybrid] {label} cli.main -1 -2 --nanopore ({len(genome)} bp): "
        f"{wall:.2f} s, peak device memory {peak / 2**30:.2f} GiB, launches "
        f"{launches}, joins by stage {joins}, rr_align_long_reads "
        f"{rec['rr_align_long_reads_s']:.3f} s")
    for name, sec in stages.items():
        log(f"[hybrid] {label} stage {name}: {sec:.3f} s "
            f"{by_stage.get(name, {})}")
    if launches["kmer_extract"] <= 0:
        raise AssertionError(f"--nanopore launched {launches}")
    # the quality bar on the genome outside the holes: a fill of long
    # read bases (10% errors) covers no hole for utils/assess
    outside_holes = 1 - sum(hi - lo for lo, hi in holes) / len(genome)
    if rec["contigs"]["genome_fraction"] < 0.97 * outside_holes or \
            rec["contigs"]["misassemblies_outside_holes"]:
        raise AssertionError(f"--nanopore quality bar missed: "
                             f"{rec['contigs']}")
    bridged = max(rec["contigs"]["holes_spanned"],
                  rec["scaffolds"]["holes_spanned"])
    if bridged < bar * len(holes):
        raise AssertionError(f"--nanopore bridged {bridged} of "
                             f"{len(holes)} holes")
    shutil.rmtree(out)
    return rec


def nanopore_cut(device, tmp) -> dict:
    """Phase 15 (a) on the 1/20 cut of its data (the same simulation at
    HYBRID_CUT bases, no domain clusters), where a long read's seed
    chain crosses a hole cleanly often enough for joins: at least half
    the holes spanned, the banded_ed kernel launched."""
    genome, g, _, _, holes = hybrid_genome(HYBRID_CUT, n_clusters=0)
    _, holed, lr_path, *_ = hybrid_reads(tmp, g, holes,
                                         np.random.default_rng(153), "cut")
    rec = nanopore_run(device, tmp, genome, holes, holed, lr_path,
                       bar=HOLES_BRIDGED, label="nanopore_cut")
    if rec["launches"]["banded_ed"] <= 0:
        raise AssertionError("--nanopore on the cut never launched "
                             "banded_ed")
    for path in os.listdir(tmp):
        if path.startswith("cut_"):
            os.remove(os.path.join(tmp, path))
    return rec


def phase_hybrid(device, tmp) -> dict:
    """Phase 15: hybrid long reads, the HMM modes and the series
    analysis at full size. (a) ``-1/-2 --nanopore`` and (b) ``-1/-2
    --bio --custom-hmms`` on phase 8's genome with its domain clusters
    planted; (c) ``--series-analysis`` on three samples of phase 12's
    genomes."""
    from spades_for_blackbird_tpu_torch.io import hmmfile
    from spades_for_blackbird_tpu_torch.ops import hmm
    t0 = time.perf_counter()
    genome, g, domains, clusters, holes = hybrid_genome()
    full, holed, lr_path, pairs, kept, n_long, long_bases = hybrid_reads(
        tmp, g, holes, np.random.default_rng(151), "hybrid")
    log(f"[hybrid] {len(genome) / 1e6:.1f} Mb genome with {len(clusters)} "
        f"domain clusters and {len(holes)} holes "
        f"({sum(h - l for l, h in holes)} bases); 2 x {kept} of 2 x "
        f"{pairs} pairs outside the holes; {n_long} long reads "
        f"({long_bases} bases); simulated and written in "
        f"{time.perf_counter() - t0:.1f} s")
    record = {"holes": holes, "clusters": clusters}

    # (a) --nanopore, at full size and on the 1/20 cut
    record["nanopore"] = nanopore_run(device, tmp, genome, holes, holed,
                                      lr_path, bar=HOLES_BRIDGED_FULL,
                                      extra=("-k", str(FULL_K)))
    for path in holed:
        os.remove(path)
    record["nanopore_cut"] = nanopore_cut(device, tmp)

    # (b) --bio --custom-hmms
    profiles = hmm_profiles(domains)
    hmm_path = os.path.join(tmp, "models.hmm")
    hmmfile.write_hmm_file(hmm_path, profiles)
    out = os.path.join(tmp, "bio")
    argv = ["-1", full[0], "-2", full[1], "--bio", "--custom-hmms", hmm_path,
            "-o", out, "--checkpoints", "none", "--trace-time", "-k",
            str(FULL_K)]
    with plain_extraction_refused():
        wall, launches, by_stage, peak = counted_cli(device, argv)
    stages, spans = stage_seconds(out, [
        "read_conversion", "error_correction", "k21", "k33", "k55",
        "gap_closing", "repeat_resolution", "extract_domains",
        "second_phase_setup", "repeat_resolution_2", "contig_output",
        "domain_graph_construction"])
    found = {}
    for name, _ in fasta_records(os.path.join(out, "gene_clusters.fasta")):
        m = re.match(r"cluster_\d+_(.+)_len_\d+$", name)
        found[tuple(m.group(1).split("+"))] = name
    held = [any(tuple(c[2]) == f or tuple(c[2][::-1]) == f for f in found)
            for c in clusters]
    rec = {"wall_s": wall, "launches": launches, "by_stage": by_stage,
           "peak_bytes": peak, "stages_s": stages,
           "clusters_held": int(sum(held)), "records": len(found)}
    log(f"[hybrid] cli.main -1 -2 --bio --custom-hmms ({len(profiles)} "
        f"profiles of {min(p.length for p in profiles)}-"
        f"{max(p.length for p in profiles)} nodes): {wall:.2f} s, peak "
        f"device memory {peak / 2**30:.2f} GiB, launches {launches}; "
        f"{sum(held)} of {len(clusters)} clusters in gene_clusters.fasta "
        f"with their domains in order ({len(found)} records)")
    for name, sec in stages.items():
        log(f"[hybrid] bio stage {name}: {sec:.3f} s "
            f"{by_stage.get(name, {})}")
    for line in log_lines(out, ["domain hits", "domain graph"]):
        log(f"[hybrid] bio log: {line}")
    if not all(held):
        raise AssertionError(f"--bio: clusters missing from "
                             f"gene_clusters.fasta: {held} {sorted(found)}")
    vit_stages = {name: n.get("viterbi", 0) for name, n in by_stage.items()
                  if n.get("viterbi")}
    log(f"[hybrid] viterbi launches by stage: {vit_stages}")
    if vit_stages != {"extract_domains": 1, "domain_graph_construction": 1}:
        raise AssertionError("--bio: expected one viterbi launch in each "
                             f"HMM stage, got {vit_stages}")
    # the kernel at the run's own rows and profiles: the batched launch of
    # all of them held against the plain version of the shortest and the
    # longest profile on every row cut to its first VITERBI_PLAIN_CUT
    # positions, then timed on the full rows; one profile alone on the
    # padded rows, and the longest row alone (the serial chain's time)
    import torch
    from spades_for_blackbird_tpu_torch.models import bio
    contigs = [s for s, _ in read_fasta(os.path.join(out, "contigs.fasta"))]
    frames = bio._frames(contigs)
    flat, offsets, lens64 = bio.frame_rows(frames)
    L = int(lens64.max())
    seqs = np.full((len(frames), L), 20, np.uint8)
    lengths = lens64.astype(np.int32)
    for i, f in enumerate(frames):
        seqs[i, :len(f[3])] = f[3]
    by_m = sorted(range(len(profiles)), key=lambda i: profiles[i].length)
    cut = VITERBI_PLAIN_CUT
    batch_cut = viterbi_batch_vs_plain(
        device, profiles, *ragged_rows(seqs, lengths, cut),
        compare=(by_m[0], by_m[-1]))
    errs = [batch_cut["max_abs_err"]]
    rows = (flat, offsets, lengths)
    batch_ms = viterbi_batch_launch_ms(device, profiles, *rows, 2)
    big = profiles[by_m[-1]]
    longest = int(np.argmax(lengths))
    chain_ms = viterbi_batch_launch_ms(
        device, [big], flat[offsets[longest]:offsets[longest] + L],
        np.zeros(1, np.int64), lengths[longest:longest + 1], 2)
    batch_bound = viterbi_bound(lengths, [p.length for p in profiles])
    full_ms = viterbi_batch_launch_ms(
        device, [big], *padded_as_ragged(seqs, lengths), 2)
    args = hmm.profile_tensors(big, device)
    s = torch.from_numpy(seqs).to(device)
    ln = torch.from_numpy(lengths).to(device)
    sc, lc = s[:, :cut].contiguous(), torch.clamp(ln, max=cut)
    plain_cut_ms = cuda_ms(lambda: hmm.viterbi_ends_plain(
        *args, sc, lc, big.length), 1)
    kernel_cut_ms = cuda_ms(lambda: hmm.viterbi_kernel(
        *args, sc, lc, big.length), 2)
    bound_ms, bound_by = viterbi_bound(lengths, big.length, L)
    cut_bound_ms, cut_bound_by = viterbi_bound(np.minimum(lengths, cut),
                                               big.length, cut)
    del s, sc
    rec["viterbi"] = {"rows": len(frames), "m": big.length,
                      "max_abs_err": max(errs),
                      "profiles_compared": 2,
                      "launches_by_stage": vit_stages,
                      "cut": {"L": cut, "ms": kernel_cut_ms,
                              "plain_ms": plain_cut_ms,
                              "bound_ms": cut_bound_ms,
                              "bound_by": cut_bound_by},
                      "full": {"L": L, "ms": full_ms, "bound_ms": bound_ms,
                               "bound_by": bound_by},
                      "batched": {"profiles": len(profiles),
                                  "positions": int(lengths.sum()),
                                  "ms": batch_ms,
                                  "bound_ms": batch_bound[0],
                                  "bound_by": batch_bound[1],
                                  "chain_ms": chain_ms,
                                  "longest_row": L,
                                  "cut": dict(batch_cut, L=cut)}}
    log(f"[hybrid] viterbi on the run's {len(frames)} rows, m="
        f"{big.length}: cut to {cut} positions {kernel_cut_ms:.3f} ms "
        f"(bound {cut_bound_ms:.6f} ms, by {cut_bound_by}), plain "
        f"{plain_cut_ms:.3f} ms, bit-equal; full (longest {L} positions) "
        f"{full_ms:.3f} ms a launch (bound {bound_ms:.6f} ms)")
    log(f"[hybrid] viterbi batched, {len(profiles)} profiles over the "
        f"{len(frames)} ragged rows ({int(lengths.sum())} positions): "
        f"{batch_ms:.3f} ms a launch (bound {batch_bound[0]:.6f} ms, by "
        f"{batch_bound[1]}; the longest row alone {chain_ms:.3f} ms); cut "
        f"to {cut} positions {batch_cut['ms']:.3f} ms, bit-equal to the "
        f"plain version ({batch_cut['plain_ms']:.3f} ms) for the "
        f"{profiles[by_m[0]].length}- and {big.length}-node profiles")
    torch.cuda.empty_cache()
    record["bio"] = rec
    # phase 16 takes the long reads, the profiles and this run's graph
    record["files"] = {"long_reads": lr_path, "hmms": hmm_path,
                       "bio_gfa": os.path.join(tmp, "bio_graph.gfa")}
    shutil.copy(os.path.join(out, "assembly_graph_with_scaffolds.gfa"),
                record["files"]["bio_gfa"])
    shutil.rmtree(out)
    for path in full:
        os.remove(path)
    record["series"] = series_run(device, tmp)
    return record


def series_run(device, tmp) -> dict:
    """Phase 15 (c): three samples of phase 12's four genomes at their
    coverages rotated a step a sample; the profile of all three counted
    on the card and saved in the JAX package's format; ``-1/-2
    --only-assembler -k 55 --series-analysis`` on the first sample. Each
    genome's edges must follow its planted ratios: the median of its
    edges' sample ratios within SERIES_RTOL of the planted one."""
    import torch
    from spades_for_blackbird_tpu_torch.mts import abundance
    from spades_for_blackbird_tpu_torch.ops import dna
    t0 = time.perf_counter()
    genomes, _, _ = metagenome(META_SCALE)
    covs = [c for _, _, _, _, c in META_GENOMES]
    names = list(genomes)
    rng = np.random.default_rng(152)
    codes = {name: dna.encode_str(s) for name, s in genomes.items()}
    planted = {name: [covs[(i + s) % len(covs)] for s in range(3)]
               for i, name in enumerate(names)}
    samples = []
    for s in range(3):
        parts = [sample_pairs(rng, codes[n], int(len(codes[n])
                                                 * planted[n][s] / 200))
                 for n in names]
        r1 = np.concatenate([p[0] for p in parts])
        r2 = np.concatenate([p[1] for p in parts])
        samples.append([with_errors(rng, r) for r in (r1, r2)])
    mates = [os.path.join(tmp, f"series_{m}.fastq") for m in (1, 2)]
    for path, (c, q) in zip(mates, samples[0]):
        write_fastq(path, c, q)
    t1 = time.perf_counter()
    batches = []
    for sample in samples:
        both = np.concatenate([sample[0][0], sample[1][0]])
        batches.append((both, np.full(len(both), FULL_READ_LEN, np.int32)))
    del samples
    torch.cuda.synchronize()
    before = {n: k.launches for n, k in all_kernels().items()}
    kmers, mult = abundance.multiplicity_profiles(
        batches, SERIES_K, min_mult=SERIES_MIN_MULT, device=device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    prof_path = os.path.join(tmp, "series_profile.npz")
    abundance.save_profiles(prof_path, kmers, mult, SERIES_K)
    t3 = time.perf_counter()
    profile_launches = {n: k.launches - before[n]
                        for n, k in all_kernels().items()}
    reads = [len(b[0]) for b in batches]
    del batches
    log(f"[series] 3 samples of {sum(map(len, genomes.values()))} bp "
        f"({reads} reads) simulated in {t1 - t0:.1f} s; profile of "
        f"{len(kmers)} k-mers (k={SERIES_K}, total >= {SERIES_MIN_MULT}) "
        f"counted on the card in {t2 - t1:.2f} s ({profile_launches}), "
        f"saved in {t3 - t2:.2f} s")
    yaml = os.path.join(tmp, "series.yaml")
    with open(yaml, "w") as f:
        f.write(f"k: {SERIES_K}\nsample_cnt: 3\nkmer_mult: {prof_path}\n"
                f"min_len: 0\nfrag_size: 200\n" + "".join(
                    f"{key}: {tmp}/series_{key}\n" for key in (
                        "edges_sqn", "edges_mpl", "edge_fragments_mpl")))
    out = os.path.join(tmp, "series")
    argv = ["-1", mates[0], "-2", mates[1], "--only-assembler", "-k",
            str(FULL_K), "--series-analysis", yaml, "-o", out,
            "--checkpoints", "none", "--trace-time"]
    with plain_extraction_refused():
        wall, launches, by_stage, peak = counted_cli(device, argv)
    stages, _ = stage_seconds(out, ["read_conversion", f"k{FULL_K}",
                                    "gap_closing", "series_analysis",
                                    "repeat_resolution", "contig_output"])
    tables = {n: kmer_set(codes[n]) for n in names}
    rows = {}
    with open(os.path.join(tmp, "series_edges_mpl")) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            rows[parts[0]] = np.asarray(parts[1:], np.float64)
    edge_seqs = dict(fasta_records(os.path.join(tmp, "series_edges_sqn")))
    names_long = [n for n in rows if len(edge_seqs[n]) >= SERIES_MIN_EDGE]
    src = assign_sources([edge_seqs[n] for n in names_long], tables)
    grades = {}
    for g in names:
        prof = np.asarray([rows[n] for n, x in zip(names_long, src)
                           if x == g])
        prof = prof[prof[:, 0] > 0] if len(prof) else prof
        got = [float(np.median(prof[:, s] / prof[:, 0])) if len(prof)
               else float("nan") for s in (1, 2)]
        want = [planted[g][s] / planted[g][0] for s in (1, 2)]
        grades[g] = {"edges": int(len(prof)), "median_ratios": got,
                     "planted_ratios": want}
        log(f"[series] {g}: {len(prof)} edges >= {SERIES_MIN_EDGE} bp, "
            f"median sample ratios {[round(x, 4) for x in got]} (planted "
            f"{[round(x, 4) for x in want]})")
        if not len(prof) or any(abs(a / b - 1) > SERIES_RTOL
                                for a, b in zip(got, want)):
            raise AssertionError(f"--series-analysis: {g} ratios {got} vs "
                                 f"{want}")
    log(f"[series] cli.main --only-assembler -k {FULL_K} "
        f"--series-analysis: {wall:.2f} s, peak device memory "
        f"{peak / 2**30:.2f} GiB, launches {launches}; {len(rows)} edges "
        f"profiled; stages {stages}")
    if by_stage.get("series_analysis", {}).get("kmer_extract", 0) <= 0:
        raise AssertionError("series_analysis never launched the kernel")
    shutil.rmtree(out)
    for path in mates + [prof_path, yaml]:
        os.remove(path)
    return {"wall_s": wall, "launches": launches, "by_stage": by_stage,
            "peak_bytes": peak, "stages_s": stages, "edges": len(rows),
            "profile_kmers": int(len(kmers)), "profile_s": t2 - t1,
            "profile_save_s": t3 - t2, "grades": grades}


def new_kernel_lines(record: dict, runs: dict) -> list[dict]:
    """The kernels line's entries of banded_ed and viterbi: launches on
    the main paths (phase 15's runs), the largest difference from the
    plain version over every comparison, and the timed shapes. viterbi's
    headline is the launch the HMM stages make: every profile over the
    --bio run's ragged rows, its plain time that of the shortest and the
    longest profile on the rows cut to VITERBI_PLAIN_CUT positions (on
    the full rows the plain version would outlast the run); one profile
    on the padded rows, the one-profile kernel's earlier shape, is kept
    under ``single_profile``."""
    new = record["kernel_vs_plain_new"]
    ed_rows = new["banded_ed"]
    ed = next(r for r in ed_rows if "ms" in r)
    vit = record["hybrid"]["bio"]["viterbi"]
    bat = vit["batched"]
    vit_rows = new["viterbi"]
    return [{
        "name": "banded_ed", "route": "cuda", "source": ED_SOURCE,
        "replaces": ED_REPLACES,
        "launches": sum(n["banded_ed"] for n in runs.values()),
        "max_abs_err": max(r["max_abs_err"] for r in ed_rows),
        "ms": ed["ms"], "plain_ms": ed["plain_ms"],
        "bound_ms": ed["bound_ms"], "bound_by": ed["bound_by"],
        "library_ms": None,
        "shape": {"B": ed["B"], "L": ed["L"], "band": ed["band"]},
        "launch_sites": {name: n["banded_ed"] for name, n in runs.items()},
    }, {
        "name": "viterbi", "route": "cuda", "source": VITERBI_SOURCE,
        "replaces": VITERBI_REPLACES,
        "launches": sum(n["viterbi"] for n in runs.values()),
        "max_abs_err": max([vit["max_abs_err"],
                            new["viterbi_batched"]["max_abs_err"]]
                           + [r["max_abs_err"] for r in vit_rows]),
        "ms": bat["ms"], "plain_ms": bat["cut"]["plain_ms"],
        "bound_ms": bat["bound_ms"], "bound_by": bat["bound_by"],
        "library_ms": None,
        "shape": {"rows": vit["rows"], "profiles": bat["profiles"],
                  "positions": bat["positions"],
                  "longest_row": bat["longest_row"]},
        "plain_shape": {"rows": vit["rows"], "L": bat["cut"]["L"],
                        "profiles": vit["profiles_compared"]},
        "batched": bat,
        "single_profile": {"m": vit["m"], "rows": vit["rows"],
                           "cut": vit["cut"], "full": vit["full"]},
        "launches_by_stage": vit["launches_by_stage"],
        "synthetic": [{key: r[key] for key in r} for r in vit_rows],
        "synthetic_batched": new["viterbi_batched"],
        "launch_sites": {name: n["viterbi"] for name, n in runs.items()},
    }]


def seg_sum_line(record: dict, runs: dict) -> dict:
    """The kernels line's entry of seg_sum: launches on the main paths
    (phase 4's assembly, phase 8's paired command, phase 15's command
    lines and phase 16's tools), the largest difference from the plain
    version over every comparison, timed on phase 4's largest float sum
    (condense's coverage sums at k = 55)."""
    main = record["full"]["seg_sum"]
    compared = record["seg_sum"]["rows"] + [main]
    sites = {"single_k": record["full"]["seg_launches"],
             "paired_cli": record["paired"]["seg_launches"]}
    sites.update({name: n["seg_sum"] for name, n in runs.items()})
    return {
        "name": "seg_sum", "route": "cuda", "source": SEG_SOURCE,
        "replaces": SEG_REPLACES, "launches": sum(sites.values()),
        "max_abs_err": max(r["max_abs_err"] for r in compared),
        "ms": main["ms"], "wrapper_ms": main["wrapper_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "bounds": {key: main[key] for key in ("bytes_bound_ms",
                                                "chain_bound_ms", "add_ns")},
        "shape": {key: main[key] for key in ("n", "M", "kept", "cols",
                                               "dtype", "slot_dtype",
                                               "slots", "longest_run",
                                               "long_runs")},
        "synthetic": record["seg_sum"]["rows"],
        "launch_sites": sites,
    }


def phase_build_alone(device) -> dict:
    return phase_build()


# the phases that need nothing of another: --only runs a few of them
def phase_full_alone(device) -> dict:
    return phase_full(device)[0]


ALONE = {"build": (phase_build_alone, False),
         "kernel_vs_plain": (phase_kernel_vs_plain, False),
         "kernel_vs_plain_new": (phase_new_kernels, False),
         "seg_sum": (phase_seg_sum, False),
         "full": (phase_full_alone, False),
         "gpu_vs_cpu": (phase_gpu_vs_cpu, False),
         "sums_gpu_vs_cpu": (sums_gpu_vs_cpu, False),
         "tools_gpu_vs_cpu": (tools_gpu_vs_cpu, False),
         "hybrid_gpu_vs_cpu": (hybrid_modes_gpu_vs_cpu, False),
         "metagenome": (phase_metagenome, True),
         "rna": (phase_rna, True),
         "hybrid": (phase_hybrid, True)}


def write_record(path: str, record: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--only", default=None, metavar="PHASES",
                    help="run only these of the phases that stand alone "
                         f"(comma-separated: {', '.join(ALONE)}) and "
                         "print no result: a shorter check")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, PACKAGE)):
        print(f"{PACKAGE}/ not found beside chip_smoke.py: run it from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    device = torch.device("cuda", 0)
    card = card_name()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    record = {"card": card}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    seconds = record["phase_s"] = {}

    def timed(name, fn, *fn_args):
        t0 = time.perf_counter()
        try:
            return fn(*fn_args)
        finally:
            seconds[name] = time.perf_counter() - t0
            log(f"[timing] {name}: {seconds[name]:.1f} s")
    if args.only:
        try:
            for name in args.only.split(","):
                fn, with_tmp = ALONE[name]
                record[name] = timed(name, fn, *(
                    (device, tmp) if with_tmp else (device,)))
        except Exception:  # any failed phase fails the smoke
            traceback.print_exc()
            print("chip_smoke: FAILED", file=sys.stderr)
            return 1
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            if args.out:
                write_record(args.out, record)
        return 0
    try:
        record["build"] = timed("build", phase_build)
        record["kernel_vs_plain"] = timed("kernel_vs_plain",
                                          phase_kernel_vs_plain, device)
        record["kernel_vs_plain_new"] = timed(
            "kernel_vs_plain_new", phase_new_kernels, device)
        record["seg_sum"] = timed("seg_sum", phase_seg_sum, device)
        record["gpu_vs_cpu"] = timed("gpu_vs_cpu", phase_gpu_vs_cpu, device)
        record["full"], (genome, codes, lengths, quals, truth, graph) = \
            timed("full", phase_full, device)
        record["ladder"] = timed("ladder", phase_ladder, device)
        record["hammer"] = timed("hammer", phase_hammer, device, genome,
                                 codes, lengths, quals, truth)
        del truth
        record["paired"] = timed("paired", phase_paired, device, genome,
                                 codes, lengths, quals, tmp)
        mates = record["paired"]["mates"]
        record["careful"] = timed("careful", phase_careful, device, genome,
                                  graph, codes, lengths, mates, tmp)
        del graph
        record["sc"] = timed("sc", phase_sc, device, genome[:SC_GENOME],
                             tmp)
        record["fork"] = timed(
            "fork", phase_fork, device, genome, codes, lengths, mates,
            os.path.join(record["paired"]["out"],
                         "assembly_graph_with_scaffolds.gfa"), tmp)
        record["metagenome"] = timed("metagenome", phase_metagenome, device,
                                     tmp, META_SCALE)
        record["plasmid"] = timed("plasmid", phase_plasmid, device, genome,
                                  codes, quals, tmp)
        record["rna"] = timed("rna", phase_rna, device, tmp)
        record["hybrid"] = timed("hybrid", phase_hybrid, device, tmp)
        record["tools"] = timed("tools", phase_tools, device, tmp, {
            "genome": genome, "mates": mates,
            "contigs": os.path.join(record["paired"]["out"],
                                    "contigs.fasta"),
            "sc_genome": genome[:SC_GENOME],
            "sc_mates": [os.path.join(tmp, f"sc_{m}.fastq") for m in (1, 2)],
            "meta": record["metagenome"]["files"],
            **record["hybrid"]["files"]})
    except Exception:  # any failed phase fails the smoke
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if args.out:
            write_record(args.out, record)

    rows = record["kernel_vs_plain"]["rows"]
    main_row = next(r for r in rows
                    if r["main_path"] and r["k"] == FULL_K + 1)
    index_rows = record["kernel_vs_plain"]["index_rows"]
    compared = (rows + record["kernel_vs_plain"]["ragged"]
                + record["gpu_vs_cpu"]["contig_windows"]
                + record["full"]["contig_windows"]
                + [index_rows, record["full"]["index_rows"]])
    hammer = record["hammer"]
    paired = record["paired"]
    careful, sc, fork = record["careful"], record["sc"], record["fork"]
    meta, plasmid, rna = (record["metagenome"], record["plasmid"],
                          record["rna"])
    sites = {
        "single_k": record["full"]["launches"],
        "ladder_cli": record["ladder"]["launches"],
        "correct_reads": hammer["launches"],
        "default_cli": hammer["cli_launches"],
        "paired_cli": paired["launches"],
        "gap_closing": paired["launches_inside"]["close_gaps"],
        "repeat_resolution":
            paired["launches_inside"]["repeat_resolution_multi"],
        "correct_mismatches": careful["launches"],
        "careful_cli": careful["cli_launches"],
        "careful_stage": careful["cli_launches_inside"],
        "sc_cli": sc["launches"],
        "uneven_single_k": sum(u["launches"] for u in sc["uneven"].values()),
        "restricted_single_k": fork["runs"]["restricted"]["launches"],
        "restricted_in_simplify":
            fork["runs"]["restricted"]["launches_in_simplify"],
        "free_single_k": fork["runs"]["free"]["launches"],
        "gfa_input_cli": fork["gfa_launches"],
        "meta_cli": meta["meta"]["launches"],
        "second_phase":
            meta["meta"]["launches_by_stage"]["second_phase_setup"],
        "metaplasmid_cli": meta["metaplasmid"]["launches"],
        "metaviral_cli": meta["metaviral"]["launches"],
        "plasmid_cli": plasmid["launches"],
        "rna_cli": rna["rna"]["launches"],
        "ss_edge_split": rna["rna"]["launches_by_stage"]["ss_edge_split"],
        "rnaviral_cli": rna["rnaviral"]["launches"]}
    hybrid = record["hybrid"]
    new_runs = {"nanopore_cli": hybrid["nanopore"]["launches"],
                "nanopore_cut_cli": hybrid["nanopore_cut"]["launches"],
                "bio_cli": hybrid["bio"]["launches"],
                "series_cli": hybrid["series"]["launches"]}
    new_runs.update({f"tool_{name}": r["launches"] for name, r in
                     record["tools"]["runs"].items()})
    sites.update({name: n["kmer_extract"] for name, n in new_runs.items()})
    # the main paths' runs; gap_closing, repeat_resolution,
    # careful_stage, restricted_in_simplify, second_phase and
    # ss_edge_split count launches inside them
    launches = sum(sites[name] for name in (
        "single_k", "ladder_cli", "correct_reads", "default_cli",
        "paired_cli", "correct_mismatches", "careful_cli", "sc_cli",
        "uneven_single_k", "restricted_single_k", "free_single_k",
        "gfa_input_cli", "meta_cli", "metaplasmid_cli", "metaviral_cli",
        "plasmid_cli", "rna_cli", "rnaviral_cli")) + sum(
        n["kmer_extract"] for n in new_runs.values())
    log("kernel launches on the main paths: " + ", ".join(
        f"{name} {n}" for name, n in sites.items()))
    strand_row = next(r for r in rows if r.get("strand_ms") is not None
                      and r["R"] == hammer["reads"])
    mapper_row = next(r for r in rows if r["mapper"])
    log(card)
    print(json.dumps({"kernels": [{
        "name": "kmer_extract",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in compared),
        "ms": main_row["ms"],
        "wrapper_ms": main_row["wrapper_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": {"R": main_row["R"], "L": main_row["L"],
                  "k": main_row["k"]},
        "ladder_shapes": [
            {key: r[key] for key in ("R", "L", "k", "max_abs_err", "ms",
                                     "plain_ms", "bound_ms", "bound_by")}
            for r in rows if r["main_path"]],
        "strand_entry": {key: strand_row[key] for key in (
            "R", "L", "k", "ms", "bound_ms", "strand_ms", "strand_bound_ms",
            "strand_plain_ms", "strand_bound_by")},
        "mapper_shape": {key: mapper_row[key] for key in (
            "R", "L", "k", "strand_ms", "strand_bound_ms", "strand_plain_ms",
            "strand_bound_by")},
        "edge_index_rows": {key: record["full"]["index_rows"][key]
                            for key in ("R", "L", "k", "last_row",
                                        "strand_ms", "wrapper_ms",
                                        "plain_ms", "bound_ms", "bound_by")},
        "launch_sites": sites,
    }] + new_kernel_lines(record, new_runs)
        + [seg_sum_line(record, new_runs)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
