"""The table of peaks and the cost of each hand kernel's launch.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, at its 700 W
limit): device memory 3.35 TB/s, float32 outside the tensor cores
67 TFLOP/s. The sheet names no integer rate; 32-bit integer instructions
run at most as fast as float32 FMAs (two operations an FMA), so 33.5 TOP/s
bounds them from above.

``kmer_*`` are frozen copies of ``chip_smoke.py::kernel_bytes``,
``kernel_ops`` and ``bound_of``. ``seg_sum_bound`` counts only bytes at
the memory rate and one float add a summed value at the float32 rate: the
chain bound of chip_smoke (an add latency timed in the same call) is a
diagnostic, not a published peak, and stays out of the roofline.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT_OPS_PER_S = F32_FLOP_PER_S / 2


def kmer_bytes(R: int, L: int, k: int, strand: bool = False) -> int:
    """What the k-mer extraction must move for (R, L) reads and
    (k)-mers: every code and length read once, every key (and, where
    k % 16 == 0, validity byte; with ``strand`` the strand byte) written
    once."""
    windows = R * (L - k + 1)
    key_cols = ((k + 15) // 16 + 1) // 2
    return (R * L + 4 * R
            + (8 * key_cols + (k % 16 == 0) + strand) * windows)


def kmer_ops(R: int, L: int, k: int) -> int:
    """The least 32-bit integer operations: a shift a word and strand, a
    compare and a select a word, a fuse a key, for every window; two
    packing operations a base and strand."""
    words = (k + 15) // 16
    windows = R * (L - k + 1)
    return windows * (4 * words + (words + 1) // 2) + 4 * R * L


def kmer_bound(R: int, L: int, k: int, strand: bool = False):
    """(least seconds, what bounds it, bytes moved) of one launch."""
    moved = kmer_bytes(R, L, k, strand)
    bytes_s = moved / HBM_BYTES_PER_S
    ops_s = kmer_ops(R, L, k) / INT_OPS_PER_S
    return (max(bytes_s, ops_s),
            "bytes" if bytes_s >= ops_s else "operations", moved)


def seg_sum_bytes(kept: int, cols: int, itemsize: int, slot_itemsize: int,
                  with_perm: bool, slots: int) -> int:
    """What one ordered sum must move for these inputs: the slot of every
    kept row read once (the rows aimed at no slot need not be read), the
    permutation once where the rows are read through it, the kept rows'
    values once, and every slot the kept rows reach read and written
    once."""
    return (kept * (slot_itemsize + (8 if with_perm else 0))
            + kept * cols * itemsize + 2 * slots * cols * itemsize)


def seg_sum_bound(kept: int, cols: int, itemsize: int, slot_itemsize: int,
                  with_perm: bool, slots: int):
    """(least seconds, what bounds it, bytes moved): bytes at the memory
    rate against one add a kept value at the float32 rate."""
    moved = seg_sum_bytes(kept, cols, itemsize, slot_itemsize, with_perm,
                          slots)
    bytes_s = moved / HBM_BYTES_PER_S
    adds_s = kept * cols / F32_FLOP_PER_S
    return (max(bytes_s, adds_s),
            "bytes" if bytes_s >= adds_s else "operations", moved)
