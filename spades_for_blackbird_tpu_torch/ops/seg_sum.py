"""Wrapper of the hand-written ordered segment-sum kernel.

Every float scatter-add of the port goes through
``segments.index_add_float``, whose card route ends here. On the CPU,
``Tensor.index_add_`` adds a slot's terms in row order, starting from
the slot's value (as XLA's CPU scatter does, which the JAX package's
parity tests rest on); the card's ``index_add_`` adds them in the order
its threads arrive. The route on the card: drop the rows aimed at no
slot, sort the rest by slot with a stable sort (once), then this kernel
(``csrc/seg_sum.cu``) adds each slot's run serially in row order from
the slot's value. The result equals the CPU's ``index_add_`` bit for
bit, on every run.

``SegSumKernel`` takes rows already sorted by slot. A CPU tensor goes to
the plain version, ``seg_sum_plain`` (``index_add_`` on the sorted rows:
the CPU adds them in row order, which is the order the kernel keeps); a
CUDA tensor launches the kernel, built with ``nvcc`` at first use. There
is no fallback from a CUDA tensor: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary

FLOAT_TYPES = (torch.float32, torch.float64)


def seg_sum_plain(out: torch.Tensor, slot: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``out[slot[i]] += vals[i]`` in row order, in place: ``out`` (n, C),
    ``slot`` (M,) int64 sorted, ``vals`` (M, C) of ``out``'s dtype."""
    return out.index_add_(0, slot, vals)


def _declare(lib) -> None:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.sfb_seg_sum.restype = ctypes.c_int
    lib.sfb_seg_sum.argtypes = [p, p, i64, i64, p, ctypes.c_int, p]
    lib.sfb_seg_sum_error.restype = ctypes.c_char_p
    lib.sfb_seg_sum_error.argtypes = [ctypes.c_int]


class SegSumKernel:
    """Callable wrapper of ``csrc/seg_sum.cu`` with the contract of
    ``seg_sum_plain``. ``launches`` counts kernel launches (in
    ``launch``; CPU calls do not count)."""

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary("seg_sum.cu", _declare)

    def __call__(self, out: torch.Tensor, slot: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
        if out.device.type == "cpu":
            return seg_sum_plain(out, slot, vals)
        if out.dtype not in FLOAT_TYPES or vals.dtype != out.dtype:
            raise ValueError(f"out and vals must share a float dtype, got "
                             f"{out.dtype} and {vals.dtype}")
        if out.device.type != "cuda":
            raise ValueError(f"unsupported device {out.device}")
        if out.dim() != 2 or vals.dim() != 2 or vals.shape[1] != out.shape[1]:
            raise ValueError(f"out (n, C) and vals (M, C) expected, got "
                             f"{tuple(out.shape)} and {tuple(vals.shape)}")
        if (slot.dtype != torch.int64 or tuple(slot.shape) != (vals.shape[0],)
                or slot.device != out.device or vals.device != out.device):
            raise ValueError(f"slot must be ({vals.shape[0]},) int64 on "
                             f"{out.device}")
        if not out.is_contiguous():
            raise ValueError("out must be contiguous")
        if slot.numel() and out.numel():
            self.launch(out, slot.contiguous(), vals.contiguous())
        return out

    def launch(self, out, slot, vals) -> None:
        """The bare launch on the current stream; ``__call__`` checks the
        inputs before it comes here."""
        lib = self.library.load()
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.sfb_seg_sum(slot.data_ptr(), vals.data_ptr(),
                                  vals.shape[0], vals.shape[1],
                                  out.data_ptr(),
                                  int(out.dtype == torch.float64), stream)
        if err:
            raise RuntimeError("seg_sum launch failed: "
                               + lib.sfb_seg_sum_error(err).decode())
        self.launches += 1


seg_sum = SegSumKernel()
