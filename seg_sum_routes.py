#!/usr/bin/env python3
"""Time the routes of the ordered float sum on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 seg_sum_routes.py [--no-assembly] [--earlier-source FILE]
                              [--out FILE]

On ``chip_smoke.py``'s phase 2 shapes (the same seeds) and, unless
``--no-assembly``, on condense's coverage sums of its phase 4 assembly
(4.6 Mb at k = 55, the largest float sum of that run), it times with
CUDA events:

- the bare ``seg_sum`` launch reading the rows through the sort's
  permutation, and on the rows copied out in sorted order;
- three routes to the same sums: "gather" (int32 keys, the dropped rows
  keyed at the limit, the kernel reading through the permutation: the
  port's route for rows of one value), "materialize" (the same sort,
  the sorted rows copied out first: the port's route for wider rows)
  and "compact" (the dropped rows compacted away, int64 keys, the
  sorted rows copied out);
- with ``--earlier-source`` (an earlier ``csrc/seg_sum.cu`` whose entry
  is ``sfb_seg_sum(slot, vals, M, C, out, is_double, stream)``: sorted
  int64 slots of the kept rows and those rows copied out), that kernel
  and this one on the same input, the kept rows' int64 slots and rows
  copied out, each held to the plain version's bits first.

Each route's sums are first held to the CPU's ``index_add_`` bit for
bit. The card's name and power limit (nvidia-smi) come first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def routes(index, src, limit: int):
    """name -> a function that adds ``src`` into a fresh zero ``out`` at
    ``index`` on the card and returns ``out``; every route drops the
    rows at ``limit``."""
    import torch
    from spades_for_blackbird_tpu_torch.ops import seg_sum, segments
    kernel = seg_sum.seg_sum
    cols = 1 if src.dim() == 1 else src.shape[1]
    rows = src.reshape(len(index), cols)

    def fresh():
        return torch.zeros((limit + 1, cols), dtype=src.dtype,
                           device=src.device)

    def gather():
        slot, perm = segments.sorted_slots(index, limit)
        return kernel(fresh(), slot, rows, perm=perm, limit=limit)

    def materialize():
        slot, perm = segments.sorted_slots(index, limit)
        return kernel(fresh(), slot, rows[perm], limit=limit)

    def compact():
        keep = index < limit
        slot, perm = torch.sort(index[keep], stable=True)
        return kernel(fresh(), slot, rows[keep][perm], limit=limit)
    return {"gather": gather, "materialize": materialize,
            "compact": compact}


def earlier_kernel(source: str):
    """A function (out, slot, vals) that launches the kernel of an
    earlier ``seg_sum.cu`` (int64 slots, rows copied out) on the current
    stream, built from ``source``."""
    import ctypes
    import torch
    from spades_for_blackbird_tpu_torch.ops.cuda_build import CudaLibrary

    def declare(lib):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.sfb_seg_sum.restype = i
        lib.sfb_seg_sum.argtypes = [p, p, i64, i64, p, i, p]
    lib = CudaLibrary(os.path.abspath(source), declare).load()

    def launch(out, slot, vals):
        err = lib.sfb_seg_sum(slot.data_ptr(), vals.data_ptr(),
                              slot.shape[0], vals.shape[1], out.data_ptr(),
                              int(out.dtype == torch.float64),
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier seg_sum launch failed: {err}")
    return launch


def time_shape(cs, what: str, index, src, limit: int,
               earlier=None) -> dict:
    """The kernel both ways and the three routes on one scatter (index
    and src on the CPU); with ``earlier``, that kernel and this one on
    the kept rows' int64 slots and rows copied out."""
    import torch
    from spades_for_blackbird_tpu_torch.ops import seg_sum, segments
    kernel = seg_sum.seg_sum
    cols = 1 if src.dim() == 1 else src.shape[1]
    want = torch.zeros((limit + 1, cols), dtype=src.dtype).index_add_(
        0, index, src.reshape(len(index), cols))[:limit]
    idx_d, src_d = index.cuda(), src.cuda()
    row = {"what": what, "M": len(index), "cols": cols,
           "dtype": str(src.dtype)}
    fns = routes(idx_d, src_d, limit)
    for name, fn in fns.items():
        if not cs.float_bits_equal(fn()[:limit], want):
            raise AssertionError(f"route {name} ({what}) != the CPU's bits")
    slot, perm = segments.sorted_slots(idx_d, limit)
    rows = src_d.reshape(len(index), cols)
    vals = rows[perm]
    out = torch.zeros((limit + 1, cols), dtype=src.dtype, device="cuda")
    row["kernel_perm_ms"] = cs.cuda_ms(
        lambda: kernel.launch(out, slot, rows, perm, limit), 10)
    row["kernel_copied_ms"] = cs.cuda_ms(
        lambda: kernel.launch(out, slot, vals, None, limit), 10)
    row["routes_ms"] = {name: cs.cuda_ms(fn, 5) for name, fn in fns.items()}
    if earlier is not None:
        kept = int((slot < limit).sum())
        slot64, vals_k = slot[:kept].to(torch.int64), vals[:kept]
        plain = seg_sum.seg_sum_plain(out.cpu(), slot64.cpu(), vals_k.cpu(),
                                      limit=limit)
        for name, fn in (("earlier", earlier), ("this", lambda o, s, v:
                                                kernel(o, s, v, limit=limit))):
            got = out.clone()
            fn(got, slot64, vals_k)
            if not cs.float_bits_equal(got, plain):
                raise AssertionError(f"{name} kernel ({what}) != plain")
        row["same_input_ms"] = {
            "earlier": cs.cuda_ms(lambda: earlier(out, slot64, vals_k), 10),
            "this": cs.cuda_ms(lambda: kernel.launch(out, slot64, vals_k,
                                                     None, limit), 10)}
    print(json.dumps(row), flush=True)
    return row


def condense_sum(cs):
    """(index, src, limit) of the largest float sum of phase 4's
    assembly, on the CPU."""
    import torch
    from spades_for_blackbird_tpu_torch.pipeline import assemble
    _, codes, lengths, _, _ = cs.simulate_reads(
        cs.FULL_GENOME, cs.FULL_COVERAGE, cs.FULL_READ_LEN, seed=7,
        truth=True)
    with cs.record_largest_float_sum() as seen:
        assemble.assemble_single_k(codes, lengths, cs.FULL_K,
                                   device=torch.device("cuda", 0))
    _, index, src, limit = seen["args"]
    return index.cpu(), src.cpu(), limit


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--no-assembly", action="store_true",
                    help="skip condense's sums (the 4.6 Mb assembly)")
    ap.add_argument("--earlier-source", default=None, metavar="FILE",
                    help="an earlier csrc/seg_sum.cu to time beside this "
                         "kernel on the same input")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    print(cs.card_name(), flush=True)
    earlier = earlier_kernel(args.earlier_source) if args.earlier_source \
        else None
    rng = np.random.default_rng(16)
    out = []
    for what, n, M, cols, share, hot, dtype in (
            ("collision-heavy", 1000, 4_000_000, 1, 0.7, 3, torch.float32),
            ("uniform", 1 << 22, 1 << 24, 1, 0.0, 1, torch.float32),
            ("quality sums (N, 21)", 1 << 18, 1 << 20, 21, 0.1, 8,
             torch.float32),
            ("float64 moments (N, 3)", 1 << 16, 1 << 20, 3, 0.3, 5,
             torch.float64)):
        index, src = cs.adversarial_rows(rng, n, M, cols, share, hot, dtype)
        out.append(time_shape(cs, what, index, src, n, earlier))
    rng = np.random.default_rng(161)
    index, src = cs.adversarial_rows(rng, 1000, 1_200_000, 1, 1.0, 1,
                                     torch.float32)
    out.append(time_shape(cs, "one run", index, src, 1000, earlier))
    index, src, n = cs.mixed_runs(rng, 21, torch.float32)
    out.append(time_shape(cs, "mixed run lengths (N, 21)", index, src, n,
                          earlier))
    if not args.no_assembly:
        index, src, limit = condense_sum(cs)
        out.append(time_shape(cs, f"k={cs.FULL_K} condense", index, src,
                              limit, earlier))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": cs.card_name(), "rows": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
