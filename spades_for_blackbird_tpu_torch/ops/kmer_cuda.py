"""Wrapper of the hand-written CUDA k-mer extraction kernel.

The kernel (``csrc/kmer_extract.cu``) replaces the TPU kernel
the JAX package's ``ops/kmer_pallas.py::_kernel``: canonical
k-mers of every window of a read batch, written as the keys the counting
sort sorts (``segments.fused_cols`` of the canonical words, invalid
windows as the fused all-ones sentinel where k % 16 != 0). A second entry,
``extract_canonical_keys``, also writes one strand byte a window (1 where
the forward k-mer is the canonical one), which the error corrector's
passes need to orient a window's bases and qualities.

Design, in short (the source's note has the whole of it): a block packs
each read of its tile once into 2-bit words in shared memory, both
strands and one "bad" bit a base, and every window is then a few funnel
shifts of those words; the codes arrive by bulk asynchronous copies,
two stages deep, in persistent blocks; neighbouring threads store
neighbouring 8-byte keys. The bound is device memory: 1 byte a base and
4 bytes a read in, 8*ceil(W/2) bytes a window out (864 MB, 0.26 ms at
3.35 TB/s, at R = 1,048,576, L = 100, k = 56).

The wrapper dispatches on the device of its input. A CPU tensor goes to
the plain PyTorch version, ``ops/kmer.py::extract_sort_keys`` (or
``extract_canonical_keys``); a CUDA
tensor launches the kernel, which is built with ``nvcc`` from the
package's own source at first use into the package's ``build/``
directory, and loaded through ``ctypes``. There is no fallback from a
CUDA tensor: a missing ``nvcc``, a failed build or a failed launch
raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import timetrace
from . import dna, kmer
from .cuda_build import CudaLibrary

MAX_K = 8 * dna.BASES_PER_WORD  # 128: the k=127 rung's (k+1)-mers
MAX_L = 4096  # 16 reads of a tile, staged twice and packed, fit a block


def _declare(lib) -> None:
    lib.sfb_kmer_extract.restype = ctypes.c_int
    lib.sfb_kmer_extract.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.sfb_error_string.restype = ctypes.c_char_p
    lib.sfb_error_string.argtypes = [ctypes.c_int]


class KmerExtractKernel:
    """Callable wrapper: ``(codes, lengths, k) -> (keys (G, R*P) int64,
    valid)``, the contract of ``ops/kmer.py::extract_sort_keys``:
    ``valid`` is None when k % 16 != 0 and the (R*P,) bool column
    otherwise. ``canonical_keys`` is the entry with the strand column.

    ``launches`` counts kernel launches of both entries, in ``launch``
    (CPU calls do not count); while the time trace is on, ``launch``
    records each launch's shape there. ``library`` builds and loads
    ``csrc/kmer_extract.cu`` (``ops/cuda_build.py``).
    """

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary("kmer_extract.cu", _declare)

    def __call__(self, codes: torch.Tensor, lengths: torch.Tensor, k: int):
        if codes.device.type == "cpu":
            return kmer.extract_sort_keys(codes, lengths, k)
        keys, valid, _ = self._run(codes, lengths, k, strand=False)
        return keys, valid

    def canonical_keys(self, codes: torch.Tensor, lengths: torch.Tensor,
                       k: int):
        """``(codes, lengths, k) -> (keys, valid, is_fwd (R*P,) bool)``,
        the contract of ``ops/kmer.py::extract_canonical_keys``."""
        if codes.device.type == "cpu":
            return kmer.extract_canonical_keys(codes, lengths, k)
        return self._run(codes, lengths, k, strand=True)

    def _run(self, codes, lengths, k, strand: bool):
        """Check the inputs, allocate the outputs and launch."""
        if codes.device.type != "cuda":
            raise ValueError(f"unsupported device {codes.device}")
        if codes.dtype != torch.uint8 or codes.dim() != 2:
            raise ValueError(f"codes must be (R, L) uint8, got "
                             f"{tuple(codes.shape)} {codes.dtype}")
        R, L = codes.shape
        if (lengths.dtype != torch.int32 or tuple(lengths.shape) != (R,)
                or lengths.device != codes.device):
            raise ValueError(f"lengths must be ({R},) int32 on {codes.device}")
        if not (codes.is_contiguous() and lengths.is_contiguous()):
            raise ValueError("codes and lengths must be contiguous")
        if not 1 <= k <= min(L, MAX_K):
            raise ValueError(f"k={k} outside 1..min(L={L}, {MAX_K})")
        if L > MAX_L or R * L >= 2 ** 31:
            raise ValueError(f"read batch ({R}, {L}) exceeds the kernel's "
                             f"limits (L <= {MAX_L}, R*L < 2**31)")
        n = R * (L - k + 1)
        key_cols = (dna.words_per_kmer(k) + 1) // 2
        keys = torch.empty((key_cols, n), dtype=torch.int64,
                           device=codes.device)
        valid = None
        if k % dna.BASES_PER_WORD == 0:  # all-ones is a real k-mer
            valid = torch.empty(n, dtype=torch.uint8, device=codes.device)
        fwd = (torch.empty(n, dtype=torch.uint8, device=codes.device)
               if strand else None)
        if R:
            self.launch(codes, lengths, k, keys, valid, fwd)
        return (keys, None if valid is None else valid.view(torch.bool),
                None if fwd is None else fwd.view(torch.bool))

    def launch(self, codes: torch.Tensor, lengths: torch.Tensor, k: int,
               keys: torch.Tensor, valid: torch.Tensor | None,
               fwd: torch.Tensor | None = None) -> None:
        """The bare launch on the current stream: the sort keys into
        ``keys`` ((G, R*P) int64), where k % 16 == 0 validity into
        ``valid`` ((R*P,) uint8; None otherwise) and, where ``fwd`` is
        given, the strand bytes into it ((R*P,) uint8). ``_run`` checks
        the inputs and allocates the outputs before it comes here."""
        R, L = codes.shape
        lib = self.library.load()
        with torch.cuda.device(codes.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.sfb_kmer_extract(
                codes.data_ptr(), lengths.data_ptr(), R, L, k,
                keys.data_ptr(),
                None if valid is None else valid.data_ptr(),
                None if fwd is None else fwd.data_ptr(), stream)
        if err:
            raise RuntimeError("kmer_extract launch failed: "
                               + lib.sfb_error_string(err).decode())
        self.launches += 1
        if timetrace.enabled():
            timetrace.record_launch("kmer_extract", R=R, L=L, k=k,
                                    strand=fwd is not None)


extract_sort_keys = KmerExtractKernel()
extract_canonical_keys = extract_sort_keys.canonical_keys
