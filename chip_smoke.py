#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card and
the CUDA toolkit):

    python3 chip_smoke.py [--out result.json] [--host-profile]

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
   sort keys and validity must be bit-equal; CUDA events time the bare
   kernel launch, the wrapper (the call the counter makes: allocation
   and launch) and the plain version, beside the bound: the larger of
   the bytes the kernel must move over the card's memory rate and its
   integer operations over the card's instruction rate; ``count_kmers`` on
   one chunk is timed too;
3. ``assemble_single_k`` at k=21 on a 20 kb simulated genome on the card
   and on the CPU: identical canonical contigs, coverages within
   rtol 1e-4 (float32 sums run in another order on the card); the
   kernel against its plain version on the contig windows
   (``_windows_from_sequences``) of that assembly at k+1 = 34 and 56,
   aligned and as a misaligned view; then the same reads as a FASTQ file
   through the command line twice, ``--device cuda`` and ``--device
   cpu``, at -k 21,33,55: identical contig sequences, coverages within
   rtol 1e-4, identical GFA segments and links;
4. the full-size run: ``assemble_single_k`` at k=55 on a simulated
   E. coli-sized genome (4.6 Mb, seed 7, 40x, 100 bp paired reads,
   error rate 0.002, planted repeats), graded against the truth with
   ``utils/assess``: genome fraction >= 0.97 and no misassembly; the
   kernel's launch count over the run must be positive; then the kernel
   against its plain version on the contig windows of this assembly, at
   k+1 = 34 and 56: the row counts the ladder's later rungs hand it;
5. the profile: the same assembly again (phase 4 was its warm-up) under
   ``torch.profiler`` (device time by kernel, and the card's busy share:
   the union of device spans over the run's wall); with
   ``--host-profile`` once more under ``cProfile`` (the host's hot
   functions);
6. the ladder at full size through the command line: the same simulated
   reads written as one FASTQ file, then ``cli.main(["-s", fq, "-o", out,
   "--only-assembler", "--trace-time"])``, the default ladder 21, 33, 55.
   It must return 0, meet the same quality bar on ``contigs.fasta``, write
   a GFA that reads back with one segment a live edge pair, and launch the
   kernel at least 5 times (3 rungs on the reads, 2 on contig windows).
   Wall seconds of the call, of each stage, of ``count_extra_contigs``
   and of the checkpoint saves are printed, and the peak device memory;
   ``--continue`` on the finished directory must return 0 and run no
   stage.

Without a CUDA card, or outside a checkout of the repository, it exits
2 before printing any result. The last two lines of standard output are
the kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
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
FULL_GENOME = 4_600_000  # E. coli size, as scale_bench.py's 4.6 Mb run
FULL_COVERAGE = 40.0
FULL_READ_LEN = 100
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
# The data sheet names no integer rate. 32-bit integer instructions run
# at most as fast as float32 FMAs outside the tensor cores (67 TFLOP/s,
# two operations an FMA), so that rate bounds them from above.
INT_OPS_PER_S = 67e12 / 2
COV_RTOL = 1e-4
PROFILE_TOP_KERNELS = 25
PROFILE_TOP_HOST = 40


def log(msg: str) -> None:
    print(msg, flush=True)


def encode_fixed(reads: list[str]) -> np.ndarray:
    """Equal-length ASCII reads -> (R, L) uint8 codes."""
    from spades_for_blackbird_tpu_torch.ops import dna
    return dna.encode_str("".join(reads)).reshape(len(reads), len(reads[0]))


def simulate_reads(genome_size: int, coverage: float, read_len: int,
                   seed: int, error_rate: float = 0.002):
    """scale_bench.py's simulation: planted repeats, FR pairs, insert 300.
    Returns (genome, codes (R, L) uint8, lengths (R,) int32)."""
    from spades_for_blackbird_tpu_torch.utils import simulate
    genome = simulate.random_genome(genome_size, seed=seed,
                                    repeats=[(2000, 3), (700, 4), (400, 6)])
    n_pairs = int(coverage * genome_size / (2 * read_len))
    r1, _, r2, _ = simulate.simulate_paired_reads(
        genome, n_pairs, read_len=read_len, insert_mean=300.0,
        insert_sd=25.0, error_rate=error_rate, seed=seed + 1)
    codes = encode_fixed(r1 + r2)
    return genome, codes, np.full(codes.shape[0], read_len, np.int32)


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


def kernel_bytes(R: int, L: int, k: int) -> int:
    """What the kernel must move: every code and length read once, every
    key (and, where k % 16 == 0, validity byte) written once."""
    windows = R * (L - k + 1)
    key_cols = ((k + 15) // 16 + 1) // 2
    return R * L + 4 * R + (8 * key_cols + (k % 16 == 0)) * windows


def kernel_ops(R: int, L: int, k: int) -> int:
    """The least 32-bit integer operations the function needs: a shift a
    word and strand, a compare and a select a word, a fuse a key, for
    every window; two packing operations a base and strand."""
    words = (k + 15) // 16
    windows = R * (L - k + 1)
    return windows * (4 * words + (words + 1) // 2) + 4 * R * L


def compare_kernel(kernel, c, ln, k) -> float:
    """Kernel vs plain version on the same tensors: the largest absolute
    difference of the unfused words and validity (0.0: bit-equal)."""
    import torch
    from spades_for_blackbird_tpu_torch.ops import dna, kmer, segments
    keys, valid = kernel(c, ln, k)
    ref_keys, ref_valid = kmer.extract_sort_keys(c, ln, k)
    torch.cuda.synchronize()
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


def phase_kernel_vs_plain(device) -> dict:
    """Bit-equality and timing of the kernel against the plain version."""
    import torch
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
    rows = []
    for L in (100, 150):
        shapes = [sh for sh in dict.fromkeys(SMOKE_SHAPES + main_shapes)
                  if sh[0] == L]
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
            del keys, flags
            wrapper_ms = cuda_ms(lambda: kernel(c, ln, k), 10)
            plain_ms = cuda_ms(lambda: kmer.extract_sort_keys(c, ln, k), 3)
            moved = kernel_bytes(R, L, k)
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = kernel_ops(R, L, k) / INT_OPS_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            row = {"L": L, "k": k, "R": R, "windows": n,
                   "bit_equal": err == 0.0, "max_abs_err": err, "ms": ms,
                   "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                   "kernel_bytes": moved, "bound_ms": bound_ms,
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations", "ops_bound_ms": ops_ms,
                   "bound_share": bound_ms / ms,
                   "kernel_GBps": moved / ms / 1e6,
                   "main_path": (L, k, R) in main_shapes}
            rows.append(row)
            log(f"[kernel] L={L} k={k} R={R} max_abs_err={err} kernel "
                f"{ms:.3f} ms ({row['kernel_GBps']:.0f} GB/s; bound "
                f"{bound_ms:.3f} ms, {row['bound_share']:.0%} of it) "
                f"wrapper {wrapper_ms:.3f} ms plain {plain_ms:.3f} ms")
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
    return {"rows": rows, "ragged": ragged}


def canonical_contigs(contigs):
    from spades_for_blackbird_tpu_torch.ops import dna
    return sorted((min(s, dna.revcomp_str(s)), c) for s, c in contigs)


def phase_gpu_vs_cpu(device) -> dict:
    from spades_for_blackbird_tpu_torch.pipeline import assemble
    _, codes, lengths = simulate_reads(20_000, 40.0, 100, seed=5)
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
    ladder = cli_gpu_vs_cpu(codes, lengths)
    return {"contigs": len(a), "gpu_s": t_gpu, "cpu_s": t_cpu,
            "contig_windows": windows, "cli_ladder": ladder}


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
    """([(segment, sequence, coverage)], [link lines]) of a GFA file."""
    segs, links = [], []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if parts[0] == "S":
                segs.append((parts[1], parts[2], float(parts[3][5:])))
            elif parts[0] == "L":
                links.append(line)
    return segs, links


def cli_gpu_vs_cpu(codes, lengths) -> dict:
    """The ladder through the command line on the card and on the CPU."""
    from spades_for_blackbird_tpu_torch import cli
    from spades_for_blackbird_tpu_torch.io import fastq
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        fq = os.path.join(tmp, "reads.fastq")
        fastq.write_reads_fastq(fq, codes, lengths)
        walls = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            rc = cli.main(["-s", fq, "-o", os.path.join(tmp, dev), "-k",
                           "21,33,55", "--only-assembler", "--device", dev])
            walls[dev] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"cli.main --device {dev} returned {rc}")
        a, b = (read_fasta(os.path.join(tmp, d, "contigs.fasta"))
                for d in ("cuda", "cpu"))
        if [s for s, _ in a] != [s for s, _ in b]:
            raise AssertionError("CLI contigs differ between card and CPU")
        if not np.allclose([c for _, c in a], [c for _, c in b],
                           rtol=COV_RTOL, atol=1e-6):
            raise AssertionError("CLI contig coverages differ")
        (sa, la), (sb, lb) = (gfa_records(os.path.join(
            tmp, d, "assembly_graph_with_scaffolds.gfa"))
            for d in ("cuda", "cpu"))
        if [x[:2] for x in sa] != [x[:2] for x in sb] or la != lb:
            raise AssertionError("GFA segments or links differ between "
                                 "card and CPU")
        if not np.allclose([x[2] for x in sa], [x[2] for x in sb],
                           rtol=COV_RTOL, atol=1e-6):
            raise AssertionError("GFA segment coverages differ")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[gpu-vs-cpu] 20 kb ladder 21,33,55 through the CLI: {len(a)} "
        f"identical contigs, {len(sa)} identical segments, {len(la)} "
        f"identical links; card {walls['cuda']:.2f} s, cpu "
        f"{walls['cpu']:.2f} s")
    return {"contigs": len(a), "segments": len(sa), "links": len(la),
            "gpu_s": walls["cuda"], "cpu_s": walls["cpu"]}


def phase_full(device) -> tuple[dict, tuple]:
    """The full-size assembly; returns its record, and the genome and its
    reads."""
    import torch
    from spades_for_blackbird_tpu_torch.ops import kmer_cuda
    from spades_for_blackbird_tpu_torch.pipeline import assemble
    from spades_for_blackbird_tpu_torch.utils import assess, timetrace

    t0 = time.perf_counter()
    genome, codes, lengths = simulate_reads(FULL_GENOME, FULL_COVERAGE,
                                            FULL_READ_LEN, seed=7)
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
    scopes: dict[str, float] = {}
    for ev in timetrace.events():
        scopes[ev["name"]] = scopes.get(ev["name"], 0.0) + ev["dur"] / 1e6
    for name, sec in sorted(scopes.items(), key=lambda kv: -kv[1]):
        log(f"[full] scope {name}: {sec:.3f} s")
    report = assess.assess([s for s, _ in res.contigs], genome)
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
    return {"genome_size": FULL_GENOME, "reads": int(codes.shape[0]),
            "k": FULL_K, "wall_s": wall, "sim_s": sim_s,
            "peak_bytes": int(peak), "launches": launches,
            "scopes_s": scopes, "stats": res.stats,
            "contig_windows": windows,
            "assess": report.to_dict()}, (genome, codes, lengths)


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


def phase_profile(device, codes, lengths, host_profile: bool) -> dict:
    """Where the full-size assembly spends its time on the card and, with
    ``host_profile``, on the host."""
    import torch
    from spades_for_blackbird_tpu_torch.pipeline import assemble

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        assemble.assemble_single_k(codes, lengths, FULL_K, device=device)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_wall = run()
    rows, device_sum, busy = device_table(prof)
    log(f"[profile] wall under torch.profiler: {prof_wall:.3f} s")
    if rows:
        log(f"[profile] device busy union {busy:.3f} s = "
            f"{busy / prof_wall:.1%} of the profiled wall; device time "
            f"summed {device_sum:.3f} s")
    else:  # the profiler could not trace the card; time is not measured
        log("[profile] torch.profiler saw no device span: device time "
            "not measured")
    for name, sec, n in rows[:PROFILE_TOP_KERNELS]:
        log(f"[profile] {sec:8.4f} s {n:7d}x  {name[:150]}")
    record = {"profiled_wall_s": prof_wall, "device_busy_union_s": busy,
              "device_busy_share": busy / prof_wall if rows else None,
              "device_summed_s": device_sum, "device_kernels": rows}
    if host_profile:
        host = cProfile.Profile()
        host.enable()
        record["cprofile_wall_s"] = run()
        host.disable()
        text = io.StringIO()
        pstats.Stats(host, stream=text).sort_stats("cumulative").print_stats(
            PROFILE_TOP_HOST)
        log(f"[profile] wall under cProfile: "
            f"{record['cprofile_wall_s']:.3f} s")
        log(text.getvalue())
        record["cprofile"] = text.getvalue()
    return record


def trace_seconds(path: str) -> dict[str, float]:
    """Seconds by span name of a time trace the command line wrote."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: dict[str, float] = {}
    for ev in events:
        out[ev["name"]] = out.get(ev["name"], 0.0) + ev["dur"] / 1e6
    return out


def phase_ladder(device, genome, codes, lengths, single_k: dict) -> dict:
    """The default ladder at full size, from a FASTQ file to contigs and
    graph files, through the command line."""
    import torch
    from spades_for_blackbird_tpu_torch import cli, native
    from spades_for_blackbird_tpu_torch.io import fastq, gfa
    from spades_for_blackbird_tpu_torch.ops import kmer_cuda
    from spades_for_blackbird_tpu_torch.pipeline.stages import PipelineContext
    from spades_for_blackbird_tpu_torch.utils import assess

    kernel = kmer_cuda.extract_sort_keys
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
        log(f"[ladder] ladder 21,33,55: {report.n_contigs} contigs, NG50 "
            f"{report.ng50}; single K={FULL_K}: "
            f"{single_k['n_contigs']} contigs, NG50 {single_k['ng50']}")
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
    return {"wall_s": wall, "fastq_write_s": write_s, "reader": reader,
            "peak_bytes": int(peak), "launches": launches,
            "stages_s": stages, "spans_s": spans,
            "checkpoint_save_s": spans.get("checkpoint_save", 0.0),
            "wall_less_saves_s": less_saves, "continue_s": continue_s,
            "segments": len(segments), "links": len(links),
            "assess": report.to_dict()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--host-profile", action="store_true",
                    help="phase 5 also runs the assembly under cProfile")
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
    try:
        record["build"] = phase_build()
        record["kernel_vs_plain"] = phase_kernel_vs_plain(device)
        record["gpu_vs_cpu"] = phase_gpu_vs_cpu(device)
        record["full"], (genome, codes, lengths) = phase_full(device)
        record["profile"] = phase_profile(device, codes, lengths,
                                          args.host_profile)
        record["ladder"] = phase_ladder(device, genome, codes, lengths,
                                        record["full"]["assess"])
    except Exception:  # any failed phase fails the smoke
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(record, f, indent=1)

    rows = record["kernel_vs_plain"]["rows"]
    main_row = next(r for r in rows
                    if r["main_path"] and r["k"] == FULL_K + 1)
    compared = (rows + record["kernel_vs_plain"]["ragged"]
                + record["gpu_vs_cpu"]["contig_windows"]
                + record["full"]["contig_windows"])
    log(f"kernel launches on the main paths: single K "
        f"{record['full']['launches']}, ladder through the CLI "
        f"{record['ladder']['launches']}")
    log(card)
    print(json.dumps({"kernels": [{
        "name": "kmer_extract",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": (record["full"]["launches"]
                     + record["ladder"]["launches"]),
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
