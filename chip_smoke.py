#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card and
the CUDA toolkit):

    python3 chip_smoke.py [--out result.json]

Phases, each of which raises on failure (the script then exits 1 and
prints no result):

1. the card's name and power limit (nvidia-smi); build of the CUDA
   k-mer extraction kernel from ``spades_for_blackbird_tpu_torch/csrc``;
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
   overlap by k bases, the last one ragged);
3. ``assemble_single_k`` at k=21 on a 20 kb simulated genome on the card
   and on the CPU: identical canonical contigs, coverages within
   rtol 1e-4 (float32 sums run in another order on the card); the
   kernel against its plain version on the contig windows
   (``_windows_from_sequences``) of that assembly at k+1 = 34 and 56,
   aligned and as a misaligned view; then the same reads as a FASTQ file
   through the command line twice, ``--device cuda`` and ``--device
   cpu``, at -k 21,33 (21,33,55 until phases 12-14 came; every command
   line of this phase runs that ladder): identical contig sequences,
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
   60x) through the command line on both: ``--meta -k 21,33``,
   ``--plasmid``, ``--metaplasmid``, ``--metaviral``, ``--rnaviral``,
   ``--rna --ss fr`` and ``--moleculo`` at ``-k 21``, all
   ``--only-assembler``: identical contigs, scaffolds, ``.paths``,
   ``final.lib_data``, GFA segments, links and P-lines, and identical
   ``contigs.circular.fasta``, ``contigs.linears.fasta`` and
   ``components_*.fasta`` (coverages in the headers within rtol 1e-4);
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
   with its qualities; the true reads are the same simulation with no
   errors (the generator draws the same numbers). (a) ``correct_reads``
   on the card, timed by scope: bases wrong before and after, bases it
   made wrong; at most a quarter of the wrong bases may be left. (b) the
   default command, ``cli.main(["-s", fq, "-o", out, "--checkpoints",
   "none", "--trace-time"])`` on the reads written with their qualities:
   it must return 0, meet the quality bar on ``contigs.fasta`` and log
   (a)'s correction stats. (a) runs once more under ``torch.profiler``
   (the card's busy share). The kernel must launch inside the corrector,
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
   launches and peak memory; (b) phase 8's command with ``--careful``:
   return 0, the quality bar on contigs and scaffolds, the kernel
   launched at least twice inside ``correct_mismatches``;
10. ``--sc`` at full size on uneven coverage: the 4.6 Mb genome, coverage
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
12. the metagenome at full size: four genomes of 2.0, 1.5, 1.0 and 0.5 Mb
   (seeds 21-24, GC 0.40, 0.50, 0.60, 0.45, phase 4's planted repeats) at
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
13. ``-1/-2 --plasmid`` on phase 8's reads plus a 12 kb and a 60 kb
   circular plasmid at 10 and 3 copies: return 0, each plasmid held at
   >= 90% by one record of ``contigs.fasta`` or
   ``contigs.circular.fasta``;
14. RNA at full size: (a) ``-1/-2 --rna --ss fr -k 49`` (one rung of the
   rna ladder: the coverage fit takes about 100 s a rung on this
   spectrum) on stranded FR pairs (100 bp, insert 250 +- 25) of 1,500
   simulated genes (2-6 exons, 1-3 isoforms skipping an exon, 10%
   overlapping their neighbour antisense, log-normal expression, median
   20x), at most 2M pairs: return 0, the kernel launched inside
   ``ss_edge_split``, at least ``ISOFORM_BAR`` of the isoforms at >= 20x
   held at >= 90% of their 21-mers by one contig (the share the JAX
   package's own strand split leaves, PERF.md); (b)
   ``-1/-2 --rnaviral`` on a 30 kb virus as three haplotypes (0, 1 and 3%
   apart, 80/15/5 at 2,000x): return 0, the major haplotype at genome
   fraction >= 0.95.

Phases 9-14 run with the plain extraction refused on the card. Each
phase's wall is printed as ``[timing]``.

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
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

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
PROFILE_TOP_KERNELS = 25


def log(msg: str) -> None:
    print(msg, flush=True)


def encode_fixed(reads: list[str]) -> np.ndarray:
    """Equal-length ASCII reads -> (R, L) uint8 codes."""
    from spades_for_blackbird_tpu_torch.ops import dna
    return dna.encode_str("".join(reads)).reshape(len(reads), len(reads[0]))


def simulate_reads(genome_size: int, coverage: float, read_len: int,
                   seed: int, error_rate: float = 0.002):
    """scale_bench.py's simulation: planted repeats, FR pairs, insert 300.
    Returns (genome, codes (R, L) uint8, lengths (R,) int32, quals (R, L)
    uint8 phred+33)."""
    from spades_for_blackbird_tpu_torch.utils import simulate
    genome = simulate.random_genome(genome_size, seed=seed,
                                    repeats=[(2000, 3), (700, 4), (400, 6)])
    n_pairs = int(coverage * genome_size / (2 * read_len))
    r1, q1, r2, q2 = simulate.simulate_paired_reads(
        genome, n_pairs, read_len=read_len, insert_mean=300.0,
        insert_sd=25.0, error_rate=error_rate, seed=seed + 1)
    codes = encode_fixed(r1 + r2)
    quals = np.frombuffer("".join(q1 + q2).encode("ascii"),
                          np.uint8).reshape(codes.shape).copy()
    return genome, codes, np.full(codes.shape[0], read_len, np.int32), quals


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
    from spades_for_blackbird_tpu_torch.ops import kmer_cuda
    kernel = kmer_cuda.extract_sort_keys
    t0 = time.perf_counter()
    path = kernel.build()
    seconds = time.perf_counter() - t0
    log(f"[build] {path} in {seconds:.2f} s (nvcc {kernel.build_seconds:.2f}"
        f" s)")
    usage = [ln.strip() for ln in kernel.ptxas_log.splitlines()
             if "registers" in ln or "spill" in ln]
    for ln in usage or ["cached build"]:
        log(f"[build] ptxas: {ln}")
    return {"build_s": seconds, "ptxas": usage}


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
    ladder = cli_gpu_vs_cpu(codes, lengths, quals)
    modes = modes_gpu_vs_cpu(device)
    return {"contigs": len(a), "gpu_s": t_gpu, "cpu_s": t_cpu,
            "contig_windows": windows, "hammer": hammer,
            "restricted": restricted, "cli": ladder, "modes": modes}


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


def cli_gpu_vs_cpu(codes, lengths, quals) -> dict:
    """The command line on the card and on the CPU: the ladder alone,
    the default command (correction, then the ladder) and IonHammer's
    correction alone."""
    from spades_for_blackbird_tpu_torch import cli
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
        own_gfa = os.path.join(tmp, "paired", "cuda",
                               "assembly_graph_with_scaffolds.gfa")
        runs = (("ladder", ["-s", plain, "-k", "21,33",
                            "--only-assembler"]),
                ("default", ["-s", with_quals, "-k", "21,33"]),
                ("ion", ["-s", with_quals, "--iontorrent",
                         "--only-error-correction"]),
                ("paired", pair + ["-k", "21,33"]),
                ("careful", pair + ["-k", "21,33", "--only-assembler",
                                    "--careful"]),
                ("sc", pair + ["-k", "21,33", "--only-assembler",
                               "--sc"]),
                ("gfa_input", pair + ["--only-assembler",
                                      "--assembly-graph", own_gfa]))
        for name, extra in runs:
            walls = {}
            for dev in ("cuda", "cpu"):
                t0 = time.perf_counter()
                rc = cli.main(["-o", os.path.join(tmp, name, dev),
                               "--device", dev] + extra)
                walls[dev] = time.perf_counter() - t0
                if rc != 0:
                    raise AssertionError(f"cli.main {name} --device {dev} "
                                         f"returned {rc}")
            card, cpu = (os.path.join(tmp, name, d) for d in ("cuda", "cpu"))
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
    reads and the assembled graph."""
    import torch
    from spades_for_blackbird_tpu_torch.ops import kmer_cuda
    from spades_for_blackbird_tpu_torch.pipeline import assemble
    from spades_for_blackbird_tpu_torch.utils import assess, timetrace

    t0 = time.perf_counter()
    genome, codes, lengths, quals = simulate_reads(
        FULL_GENOME, FULL_COVERAGE, FULL_READ_LEN, seed=7)
    sim_s = time.perf_counter() - t0
    log(f"[full] simulated {FULL_GENOME} bp, {codes.shape[0]} reads in "
        f"{sim_s:.1f} s")
    kernel = kmer_cuda.extract_sort_keys
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    timetrace.enable()
    kernel.launches = 0
    t0 = time.perf_counter()
    res = assemble.assemble_single_k(codes, lengths, FULL_K, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    timetrace.disable()
    peak = torch.cuda.max_memory_allocated(device)
    scopes = scope_seconds(timetrace.events())
    for name, sec in sorted(scopes.items(), key=lambda kv: -kv[1]):
        log(f"[full] scope {name}: {sec:.3f} s")
    report = assess.assess([s for s, _ in res.contigs], genome)
    res_stats = res.stats
    log(f"[full] assemble_single_k k={FULL_K}: {wall:.2f} s, peak device "
        f"memory {peak / 2**30:.2f} GiB, kernel launches {launches}")
    log(f"[full] contigs: {json.dumps(report.to_dict())}")
    if launches <= 0:
        raise AssertionError("the main path never launched the kernel")
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
            "scopes_s": scopes, "stats": res_stats,
            "contig_windows": windows, "index_rows": index_rows,
            "assess": report.to_dict()}, (genome, codes, lengths, quals, g)


def busy_union_us(spans: list[tuple[float, float]]) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def device_table(prof) -> tuple[list[list], float, float]:
    """Device spans of a ``torch.profiler`` run: per-name seconds and
    counts (largest first), their sum, and the seconds of their union."""
    from torch.autograd import DeviceType
    by_name: dict[str, list] = {}
    spans = []
    for ev in prof.events():
        # CUPTI reports the driver's full command buffer (the host waits
        # to enqueue) as an overhead span; it is no work on the card
        if ev.device_type != DeviceType.CUDA or \
                ev.name.startswith("Command Buffer Full"):
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        row = by_name.setdefault(ev.name, [ev.name, 0.0, 0])
        row[1] += (end - start) / 1e6
        row[2] += 1
    rows = sorted(by_name.values(), key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows), busy_union_us(spans) / 1e6


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
    """While open, the plain extraction functions raise when handed a
    tensor on the card: the main path must take the kernel there."""
    from spades_for_blackbird_tpu_torch.ops import kmer
    names = ("extract_kmers", "extract_canonical_kmers", "extract_sort_keys",
             "extract_canonical_keys")
    saved = {name: getattr(kmer, name) for name in names}

    def guarded(name, fn):
        def call(codes, *args, **kwargs):
            if codes.is_cuda:
                raise AssertionError(f"plain ops/kmer.py::{name} was called "
                                     f"with a tensor on the card")
            return fn(codes, *args, **kwargs)
        return call
    for name, fn in saved.items():
        setattr(kmer, name, guarded(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(kmer, name, fn)


def phase_hammer(device, genome, codes, lengths, quals) -> dict:
    """The error corrector on the 4.6 Mb simulation: ``correct_reads`` on
    the card against the true reads, then the default command."""
    import torch
    from spades_for_blackbird_tpu_torch import cli
    from spades_for_blackbird_tpu_torch.hammer import correct
    from spades_for_blackbird_tpu_torch.ops import kmer_cuda
    from spades_for_blackbird_tpu_torch.utils import assess, timetrace

    kernel = kmer_cuda.extract_sort_keys
    t0 = time.perf_counter()
    _, truth, _, _ = simulate_reads(FULL_GENOME, FULL_COVERAGE,
                                    FULL_READ_LEN, seed=7, error_rate=0.0)
    log(f"[hammer] simulated the true reads in "
        f"{time.perf_counter() - t0:.1f} s")
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
            # the same call again under torch.profiler: where the card's
            # time goes, and its busy share of the wall
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                correct.correct_reads(c, ln, quals=q, device=device)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
            rows, device_sum, busy = device_table(prof)
            profile = {"profiled_wall_s": prof_wall,
                       "device_busy_union_s": busy,
                       "device_busy_share": busy / prof_wall if rows else None,
                       "device_summed_s": device_sum,
                       "device_kernels": rows[:PROFILE_TOP_KERNELS]}
            del c, ln, q, prof
            torch.cuda.empty_cache()
            log(f"[hammer] correct_reads under torch.profiler: "
                f"{prof_wall:.3f} s, device busy union {busy:.3f} s"
                + (f" = {busy / prof_wall:.1%}" if rows else
                   " (no device span seen: not measured)"))
            for name, sec, n in rows[:10]:
                log(f"[hammer] profile {sec:8.4f} s {n:7d}x  {name[:120]}")
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
                    "--trace-time"]
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
            "scopes_s": scopes, **counts, "profile": profile,
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
    from spades_for_blackbird_tpu_torch.ops import kmer_cuda
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
        kernel.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(argv + ["-o", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel.launches
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
    for name, n in inside.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched the kernel")
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
        argv = ["-1", mates[0], "-2", mates[1], "--careful",
                "--checkpoints", "none", "--trace-time", "-o", out]
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
    import re
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


@contextlib.contextmanager
def launches_by_stage(kernel):
    """While open, every stage list the command line builds counts the
    kernel's launches inside each stage: yields {stage name: launches}."""
    import dataclasses as dc
    from spades_for_blackbird_tpu_torch.pipeline import spades_stages
    counts: dict[str, int] = {}
    build = spades_stages.build_stage_list

    def counted(stage):
        def fn(ctx):
            before = kernel.launches
            try:
                return stage.fn(ctx)
            finally:
                counts[stage.name] = (counts.get(stage.name, 0)
                                      + kernel.launches - before)
        return dc.replace(stage, fn=fn)

    def wrapped(*args, **kwargs):
        return [counted(s) for s in build(*args, **kwargs)]
    spades_stages.build_stage_list = wrapped
    try:
        yield counts
    finally:
        spades_stages.build_stage_list = build


def mode_run(device, argv, kernel):
    """``run_cli`` with the launches counted by stage too: (wall s,
    launches, launches by stage, peak device bytes)."""
    with launches_by_stage(kernel) as by_stage:
        wall, launches, _, peak = run_cli(device, argv, kernel)
    return wall, launches, dict(by_stage), peak


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


MODE_RUNS = (("meta", ["--meta", "-k", "21,33"]),
             ("plasmid", ["--plasmid", "-k", "21"]),
             ("metaplasmid", ["--metaplasmid", "-k", "21"]),
             ("metaviral", ["--metaviral", "-k", "21"]),
             ("rnaviral", ["--rnaviral", "-k", "21"]),
             ("rna", ["--rna", "--ss", "fr", "-k", "21"]),
             ("moleculo", ["--moleculo", "-k", "21"]))


def modes_gpu_vs_cpu(device) -> dict:
    """Phase 3 for the modes: each through the command line on the card
    and on the CPU, on FR pairs of a 26 kb community with a circle:
    identical contigs, scaffolds, GFA segments, links and P-lines,
    ``.paths``, ``final.lib_data``, circular and linear candidates and
    components."""
    from spades_for_blackbird_tpu_torch import cli
    tmp = tempfile.mkdtemp(prefix="chip_smoke_modes_")
    record = {}
    try:
        mates = community_20kb(tmp, np.random.default_rng(6))
        for name, flags in MODE_RUNS:
            argv = ["-1", mates[0], "-2", mates[1], "--only-assembler",
                    "--checkpoints", "none"] + flags
            walls = {}
            for dev in (str(device), "cpu"):
                t0 = time.perf_counter()
                rc = cli.main(argv + ["-o", os.path.join(tmp, name, dev),
                                      "--device", dev])
                walls[dev] = time.perf_counter() - t0
                if rc != 0:
                    raise AssertionError(f"cli.main {name} --device {dev} "
                                         f"returned {rc}")
            card, cpu = (os.path.join(tmp, name, d)
                         for d in (str(device), "cpu"))
            files = sorted(n for n in os.listdir(cpu) if n.endswith(
                (".fasta", ".paths", ".lib_data")))
            if files != sorted(n for n in os.listdir(card) if n.endswith(
                    (".fasta", ".paths", ".lib_data"))):
                raise AssertionError(f"{name}: the card and the CPU wrote "
                                     f"other files")
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
    shutil.rmtree(out)
    tables = {name: kmer_set(dna.encode_str(s))
              for name, s in genomes.items()}

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
    for path in mates:
        os.remove(path)
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
    argv = ["-1", mates[0], "-2", mates[1], "-o", out, "--plasmid",
            "--checkpoints", "none", "--trace-time"]
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


RNA_GENES = 1500
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
    tables = [kmer_set(dna.encode_str(s)) for s in seqs]
    graded, held = 0, 0
    for iso, cov in isoforms:
        if cov * cut < ISOFORM_COVERAGE:
            continue
        graded += 1
        km = kmer_set(dna.encode_str(iso))
        if any(hits_in(km, t).sum() >= ISOFORM_SHARE * len(km)
               for t in tables if len(t) >= ISOFORM_SHARE * len(km)):
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

    # (b) a 30 kb RNA virus as three haplotypes, 80/15/5 at 2,000x
    major = simulate.random_genome(int(30_000 * max(scale, 0.1)), seed=52)
    g = dna.encode_str(major)
    parts = []
    for div, mix in ((0.0, 0.80), (0.01, 0.15), (0.03, 0.05)):
        hap = g.copy()
        hit = rng.random(len(g)) < div
        hap[hit] = (hap[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        parts.append(sample_pairs(rng, hap, int(len(g) * 2000 * mix / 200)))
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
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
    try:
        record["build"] = timed("build", phase_build)
        record["kernel_vs_plain"] = timed("kernel_vs_plain",
                                          phase_kernel_vs_plain, device)
        record["gpu_vs_cpu"] = timed("gpu_vs_cpu", phase_gpu_vs_cpu, device)
        record["full"], (genome, codes, lengths, quals, graph) = \
            timed("full", phase_full, device)
        record["ladder"] = timed("ladder", phase_ladder, device)
        record["hammer"] = timed("hammer", phase_hammer, device, genome,
                                 codes, lengths, quals)
        record["paired"] = timed("paired", phase_paired, device, genome,
                                 codes, lengths, quals, tmp)
        mates = record["paired"]["mates"]
        record["careful"] = timed("careful", phase_careful, device, genome,
                                  graph, codes, lengths, mates, tmp)
        del graph
        record["sc"] = timed("sc", phase_sc, device, genome, tmp)
        record["fork"] = timed(
            "fork", phase_fork, device, genome, codes, lengths, mates,
            os.path.join(record["paired"]["out"],
                         "assembly_graph_with_scaffolds.gfa"), tmp)
        record["metagenome"] = timed("metagenome", phase_metagenome, device,
                                     tmp)
        record["plasmid"] = timed("plasmid", phase_plasmid, device, genome,
                                  codes, quals, tmp)
        record["rna"] = timed("rna", phase_rna, device, tmp)
    except Exception:  # any failed phase fails the smoke
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(record, f, indent=1)

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
    # the main paths' runs; gap_closing, repeat_resolution,
    # careful_stage, restricted_in_simplify, second_phase and
    # ss_edge_split count launches inside them
    launches = sum(sites[name] for name in (
        "single_k", "ladder_cli", "correct_reads", "default_cli",
        "paired_cli", "correct_mismatches", "careful_cli", "sc_cli",
        "uneven_single_k", "restricted_single_k", "free_single_k",
        "gfa_input_cli", "meta_cli", "metaplasmid_cli", "metaviral_cli",
        "plasmid_cli", "rna_cli", "rnaviral_cli"))
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
