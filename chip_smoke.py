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
   {22, 34, 56, 78, 128} at nine fixed chunk shapes, the shape the
   full-size run gives the kernel, and small ragged shapes (a last tile
   that is not full, one read, reads of length 0, a misaligned view);
   sort keys and validity must be bit-equal; CUDA events time the bare
   kernel launch, the wrapper (the call the counter makes: allocation
   and launch) and the plain version, beside the bound: the larger of
   the bytes the kernel must move over the card's memory rate and its
   integer operations over the card's instruction rate; ``count_kmers`` on
   one chunk is timed too;
3. ``assemble_single_k`` at k=21 on a 20 kb simulated genome on the card
   and on the CPU: identical canonical contigs, coverages within
   rtol 1e-4 (float32 sums run in another order on the card);
4. the full-size run: ``assemble_single_k`` at k=55 on a simulated
   E. coli-sized genome (4.6 Mb, seed 7, 40x, 100 bp paired reads,
   error rate 0.002, planted repeats), graded against the truth with
   ``utils/assess``: genome fraction >= 0.97 and no misassembly; the
   kernel's launch count over the run must be positive;
5. the profile: the same assembly again, once to warm up,
   once under ``torch.profiler`` (device time by kernel, and the card's
   busy share: the union of device spans over the run's wall) and once
   under ``cProfile`` (the host's hot functions).

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
import subprocess
import sys
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

    # the shape the full-size run hands the kernel: all its reads, or
    # the counting chunk where the card's free memory allows fewer
    full_reads = 2 * int(FULL_COVERAGE * FULL_GENOME / (2 * FULL_READ_LEN))
    main_shape = (FULL_READ_LEN, FULL_K + 1,
                  min(full_reads, counter.chunk_reads_for(
                      FULL_READ_LEN, FULL_K + 1, device)))
    rows = []
    for L in (100, 150):
        shapes = [sh for sh in dict.fromkeys(SMOKE_SHAPES + (main_shape,))
                  if sh[0] == L]
        most = max(R for _, _, R in shapes)
        _, codes, lengths = simulate_reads(
            most * L // 40 + L, 40.0, L, seed=21 + L)
        codes, lengths = noisy_reads(rng, codes[:most].copy(),
                                     lengths[:most].copy())
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
                   "main_path": (L, k, R) == main_shape}
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
    return {"contigs": len(a), "gpu_s": t_gpu, "cpu_s": t_cpu}


def phase_full(device) -> tuple[dict, tuple]:
    """The full-size assembly; returns its record and its reads."""
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
    peak = torch.cuda.max_memory_allocated(device)
    scopes: dict[str, float] = {}
    for ev in timetrace._events:
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
    return {"genome_size": FULL_GENOME, "reads": int(codes.shape[0]),
            "k": FULL_K, "wall_s": wall, "sim_s": sim_s,
            "peak_bytes": int(peak), "launches": launches,
            "scopes_s": scopes, "stats": res.stats,
            "assess": report.to_dict()}, (codes, lengths)


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


def phase_profile(device, codes, lengths) -> dict:
    """Where the full-size assembly spends its time, on the card and on
    the host."""
    import torch
    from spades_for_blackbird_tpu_torch.pipeline import assemble

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        assemble.assemble_single_k(codes, lengths, FULL_K, device=device)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    warm_wall = run()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_wall = run()
    rows, device_sum, busy = device_table(prof)
    host = cProfile.Profile()
    host.enable()
    cprofile_wall = run()
    host.disable()
    text = io.StringIO()
    pstats.Stats(host, stream=text).sort_stats("cumulative").print_stats(
        PROFILE_TOP_HOST)
    log(f"[profile] walls: warm {warm_wall:.3f} s, profiled "
        f"{prof_wall:.3f} s, under cProfile {cprofile_wall:.3f} s")
    if rows:
        log(f"[profile] device busy union {busy:.3f} s = "
            f"{busy / prof_wall:.1%} of the profiled wall; device time "
            f"summed {device_sum:.3f} s")
    else:  # the profiler could not trace the card; time is not measured
        log("[profile] torch.profiler saw no device span: device time "
            "not measured")
    for name, sec, n in rows[:PROFILE_TOP_KERNELS]:
        log(f"[profile] {sec:8.4f} s {n:7d}x  {name[:150]}")
    log(text.getvalue())
    return {"warm_wall_s": warm_wall, "profiled_wall_s": prof_wall,
            "cprofile_wall_s": cprofile_wall, "device_busy_union_s": busy,
            "device_busy_share": busy / prof_wall if rows else None,
            "device_summed_s": device_sum, "device_kernels": rows,
            "cprofile": text.getvalue()}


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
    try:
        record["build"] = phase_build()
        record["kernel_vs_plain"] = phase_kernel_vs_plain(device)
        record["gpu_vs_cpu"] = phase_gpu_vs_cpu(device)
        record["full"], full_reads = phase_full(device)
        record["profile"] = phase_profile(device, *full_reads)
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
    main_row = next(r for r in rows if r["main_path"])
    print(json.dumps({"kernels": [{
        "name": "kmer_extract",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": record["full"]["launches"],
        "max_abs_err": max(
            r["max_abs_err"]
            for r in rows + record["kernel_vs_plain"]["ragged"]),
        "ms": main_row["ms"],
        "wrapper_ms": main_row["wrapper_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": {"R": main_row["R"], "L": main_row["L"],
                  "k": main_row["k"]},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
