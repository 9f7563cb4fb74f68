"""Wrapper of the hand-written ordered segment-sum kernel.

Every float scatter-add of the port goes through
``segments.index_add_float``, whose card route ends here. On the CPU,
``Tensor.index_add_`` adds a slot's terms in row order, starting from
the slot's value (as XLA's CPU scatter does, which the JAX package's
parity tests rest on); the card's ``index_add_`` adds them in the order
its threads arrive. The route on the card (``segments.ordered_index_add_``):
sort the rows' slots with a stable sort (once; the rows aimed at no slot
keyed at the limit), then this kernel (``csrc/seg_sum.cu``) adds each
slot's run serially in row order from the slot's value, reading the rows
through the sort's permutation (or rows already copied out in sorted
order). The result equals the CPU's ``index_add_`` bit for bit, on
every run.

``SegSumKernel`` takes rows sorted by slot: the values themselves, or
unsorted values with the permutation that sorts them. A CPU tensor goes
to the plain version, ``seg_sum_plain`` (``index_add_`` on the sorted
rows: the CPU adds them in row order, which is the order the kernel
keeps); a CUDA tensor launches the kernel, built with ``nvcc`` at first
use. There is no fallback from a CUDA tensor: a failed build or launch
raises.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary

FLOAT_TYPES = (torch.float32, torch.float64)
SLOT_TYPES = (torch.int32, torch.int64)
TILE_BYTES = 8192   # a tile's values: a run of more rows is a long run
CHUNK_BYTES = 8192  # a long run's ring chunk; a row's values fit either


def tile_rows(cols: int, dtype: torch.dtype) -> int:
    """Rows of a tile of the kernel for rows of ``cols`` values of
    ``dtype``: the longest run a tile's thread adds; a longer run goes to
    a block of its own."""
    return max(1, TILE_BYTES // (cols * torch.finfo(dtype).bits // 8))


def chunk_rows(cols: int, dtype: torch.dtype) -> int:
    """Rows of one chunk of a long run's ring in shared memory."""
    return max(1, CHUNK_BYTES // (cols * torch.finfo(dtype).bits // 8))


def seg_sum_plain(out: torch.Tensor, slot: torch.Tensor, vals: torch.Tensor,
                  perm: torch.Tensor | None = None,
                  limit: int | None = None) -> torch.Tensor:
    """``out[slot[i]] += row i`` in row order, in place, for the slots
    below ``limit`` (default ``len(out)``): ``out`` (n, C), ``slot`` (M,)
    int32 or int64 sorted, row i ``vals[i]`` or, with ``perm``,
    ``vals[perm[i]]`` (``vals`` rows of C of ``out``'s dtype)."""
    rows = vals if perm is None else vals[perm]
    n = out.shape[0] if limit is None else limit
    keep = slot < n
    return out.index_add_(0, slot[keep], rows[keep])


def _declare(lib) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.sfb_seg_sum.restype = i
    lib.sfb_seg_sum.argtypes = [p, i, p, p, i64, i64, i64, p, i, i, i, p]
    lib.sfb_seg_sum_chain.restype = i
    lib.sfb_seg_sum_chain.argtypes = [i64, p, i, p]
    lib.sfb_seg_sum_error.restype = ctypes.c_char_p
    lib.sfb_seg_sum_error.argtypes = [i]


class SegSumKernel:
    """Callable wrapper of ``csrc/seg_sum.cu`` with the contract of
    ``seg_sum_plain``. ``launches`` counts kernel launches (in
    ``launch``; CPU calls and ``add_chain`` do not count)."""

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary("seg_sum.cu", _declare)

    def __call__(self, out: torch.Tensor, slot: torch.Tensor,
                 vals: torch.Tensor, perm: torch.Tensor | None = None,
                 limit: int | None = None) -> torch.Tensor:
        if out.device.type == "cpu":
            return seg_sum_plain(out, slot, vals, perm, limit)
        if out.dtype not in FLOAT_TYPES or vals.dtype != out.dtype:
            raise ValueError(f"out and vals must share a float dtype, got "
                             f"{out.dtype} and {vals.dtype}")
        if out.device.type != "cuda":
            raise ValueError(f"unsupported device {out.device}")
        if out.dim() != 2 or vals.dim() != 2 or vals.shape[1] != out.shape[1]:
            raise ValueError(f"out (n, C) and vals (M, C) expected, got "
                             f"{tuple(out.shape)} and {tuple(vals.shape)}")
        if out.shape[1] * out.element_size() > TILE_BYTES:
            raise ValueError(f"rows of at most {TILE_BYTES} bytes, got "
                             f"{out.shape[1]} x {out.dtype}")
        M = slot.shape[0] if slot.dim() == 1 else -1
        if (slot.dtype not in SLOT_TYPES or M < 0
                or slot.device != out.device or vals.device != out.device):
            raise ValueError(f"slot must be (M,) int32 or int64 on "
                             f"{out.device}")
        if perm is None:
            if vals.shape[0] != M:
                raise ValueError(f"vals must have {M} rows without perm")
        elif (perm.dtype != torch.int64 or tuple(perm.shape) != (M,)
              or perm.device != out.device):
            raise ValueError(f"perm must be ({M},) int64 on {out.device}")
        n = out.shape[0] if limit is None else limit
        if not 0 <= n <= out.shape[0]:
            raise ValueError(f"limit {n} outside 0..{out.shape[0]}")
        if not out.is_contiguous():
            raise ValueError("out must be contiguous")
        if M and out.numel() and n:
            self.launch(out, slot.contiguous(), vals.contiguous(),
                        None if perm is None else perm.contiguous(), n)
        return out

    def launch(self, out, slot, vals, perm, limit: int) -> None:
        """The bare launch on the current stream; ``__call__`` checks the
        inputs before it comes here."""
        lib = self.library.load()
        cols = vals.shape[1]
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.sfb_seg_sum(
                slot.data_ptr(), int(slot.dtype == torch.int64),
                None if perm is None else perm.data_ptr(), vals.data_ptr(),
                slot.shape[0], cols, limit, out.data_ptr(),
                int(out.dtype == torch.float64), tile_rows(cols, out.dtype),
                chunk_rows(cols, out.dtype), stream)
        if err:
            raise RuntimeError("seg_sum launch failed: "
                               + lib.sfb_seg_sum_error(err).decode())
        self.launches += 1

    def add_chain(self, buf: torch.Tensor, n: int) -> None:
        """One thread through ``n`` (a multiple of 8) dependent adds of
        ``buf[0:8]`` onto ``buf[8]`` (float32 or float64 on the card),
        written back to ``buf[8]``: the cost of one add of a run's chain,
        for the kernel's bound. Not counted in ``launches``."""
        if (buf.device.type != "cuda" or buf.dtype not in FLOAT_TYPES
                or buf.numel() < 9 or not buf.is_contiguous() or n % 8):
            raise ValueError("buf: 9 contiguous floats on the card; n a "
                             "multiple of 8")
        lib = self.library.load()
        with torch.cuda.device(buf.device):
            err = lib.sfb_seg_sum_chain(
                n, buf.data_ptr(), int(buf.dtype == torch.float64),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError("seg_sum chain launch failed: "
                               + lib.sfb_seg_sum_error(err).decode())


seg_sum = SegSumKernel()
