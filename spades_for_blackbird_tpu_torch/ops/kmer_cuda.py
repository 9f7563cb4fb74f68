"""Wrapper of the hand-written CUDA k-mer extraction kernel.

The kernel (``csrc/kmer_extract.cu``) replaces the TPU kernel
``spades_for_blackbird_tpu/ops/kmer_pallas.py::_kernel``: fused k-mer
extraction and canonicalisation, written column-major for the counting
sort. Its note on what bounds it sits in the source.

The wrapper dispatches on the device of its input. A CPU tensor goes to
the plain PyTorch version, ``ops/kmer.py::extract_canonical_cols``; a
CUDA tensor launches the kernel, which is built with ``nvcc`` from the
package's own source at first use into the package's ``build/``
directory, and loaded through ``ctypes``. There is no fallback from a
CUDA tensor: a missing ``nvcc``, a failed build or a failed launch
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from . import dna
from .kmer import extract_canonical_cols as plain_extract_canonical_cols

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "kmer_extract.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_K = 8 * dna.BASES_PER_WORD  # 128: the k=127 rung's (k+1)-mers
MAX_L = 49152  # one read row must fit the kernel's shared-memory tile


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then $PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(
            os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA k-mer kernel cannot be built")


class KmerExtractKernel:
    """Callable wrapper: ``(codes, lengths, k, sentinel_safe) ->
    (words (W, R*P) int64, valid (R*P,) bool)``, the contract of
    ``ops/kmer.py::extract_canonical_cols``.

    ``launches`` counts kernel launches, in ``launch`` (CPU calls do not
    count).
    ``build_seconds`` and ``ptxas_log`` describe the last build.
    """

    def __init__(self):
        self.launches = 0
        self.build_seconds = 0.0
        self.ptxas_log = ""
        self._lib = None

    def library_path(self) -> str:
        with open(SOURCE, "rb") as f:
            digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR,
                            f"libkmer_extract_{digest.hexdigest()[:12]}.so")

    def build(self) -> str:
        """Compile the kernel unless this source's library exists."""
        so = self.library_path()
        if os.path.exists(so):
            return so
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.ptxas_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:"
                               f"\n{self.ptxas_log}")
        os.replace(tmp, so)
        return so

    def _load(self):
        if self._lib is None:
            lib = ctypes.CDLL(self.build())
            lib.sfb_kmer_extract.restype = ctypes.c_int
            lib.sfb_kmer_extract.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p]
            lib.sfb_error_string.restype = ctypes.c_char_p
            lib.sfb_error_string.argtypes = [ctypes.c_int]
            self._lib = lib
        return self._lib

    def __call__(self, codes: torch.Tensor, lengths: torch.Tensor, k: int,
                 sentinel_safe: bool):
        if codes.device.type == "cpu":
            return plain_extract_canonical_cols(codes, lengths, k,
                                                sentinel_safe)
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
        P = L - k + 1
        W = dna.words_per_kmer(k)
        out = torch.empty((W, R * P), dtype=torch.int32, device=codes.device)
        valid = torch.empty(R * P, dtype=torch.uint8, device=codes.device)
        if R:
            self.launch(codes, lengths, k, sentinel_safe, out, valid)
        words = out.to(torch.int64)
        words &= dna.WORD_MASK
        return words, valid.view(torch.bool)

    def launch(self, codes: torch.Tensor, lengths: torch.Tensor, k: int,
               sentinel_safe: bool, out: torch.Tensor,
               valid: torch.Tensor) -> None:
        """The bare launch on the current stream: raw 32-bit words into
        ``out`` ((W, R*P) int32) and validity into ``valid`` ((R*P,)
        uint8). ``__call__`` checks the inputs and allocates the outputs
        before it comes here."""
        R, L = codes.shape
        lib = self._load()
        with torch.cuda.device(codes.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.sfb_kmer_extract(
                codes.data_ptr(), lengths.data_ptr(), R, L, k,
                int(bool(sentinel_safe)), out.data_ptr(), valid.data_ptr(),
                stream)
        if err:
            raise RuntimeError("kmer_extract launch failed: "
                               + lib.sfb_error_string(err).decode())
        self.launches += 1


extract_canonical_cols = KmerExtractKernel()
