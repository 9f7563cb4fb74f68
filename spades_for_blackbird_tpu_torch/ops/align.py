"""Batched banded edit distance.

PyTorch counterpart of the JAX package's ``ops/align.py`` (the
reference's per-read edit-distance code of the sensitive long-read
aligner, modules/alignment/pacbio/gap_dijkstra.cpp, ext/edlib): a batch
of sequence pairs aligns at once over the columns of a banded DP matrix.

``banded_edit_distance`` dispatches on the device of its input. A CPU
tensor goes to ``banded_edit_distance_plain``, which steps over the
columns in PyTorch; the JAX package's scan inside a column has the
closed form ``cur[w] = min over w' <= w of (x[w'] + w - w')``, which is
``w + cummin(x - w)``, exact in int32. A CUDA tensor launches the hand
kernel ``csrc/banded_ed.cu`` (one warp a pair, the whole recursion in
one launch); a failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import dna
from .cuda_build import CudaLibrary

_BIG = 1 << 20
MAX_BAND = 511  # 2*band + 1 slots: at most 32 a lane of a warp


def banded_edit_distance_plain(a: torch.Tensor, a_len: torch.Tensor,
                               b: torch.Tensor, b_len: torch.Tensor,
                               band: int = 32) -> torch.Tensor:
    """Levenshtein distance of each pair (a[i], b[i]) within a diagonal
    band: a, b (B, L) uint8 codes of one width, a_len, b_len (B,).
    Returns (B,) int32 distances (an upper bound where the optimum
    leaves the band; pairs whose length difference exceeds the band get
    ``|a_len - b_len| + min(a_len, b_len)``). The JAX package's
    operations in its order, on the tensors' device."""
    B, La = a.shape
    Lb = b.shape[1]
    if La != Lb:
        raise ValueError("pad a and b to the same width")
    dev = a.device
    W = 2 * band + 1
    a_len = a_len.to(torch.int32)
    b_len = b_len.to(torch.int32)
    row0 = torch.arange(-band, band + 1, device=dev, dtype=torch.int32)
    slot = torch.arange(W, device=dev, dtype=torch.int32)
    dp = torch.where(row0 >= 0, row0, _BIG).expand(B, W).clone()
    a_pad = torch.nn.functional.pad(a, (band + 1, band + 1),
                                    value=dna.INVALID_CODE)
    big = torch.full((B, 1), _BIG, dtype=torch.int32, device=dev)
    scan_floor = _BIG + 1 + slot
    for j in range(Lb):
        jj = j + 1
        rows = jj + row0
        bj = b[:, j:j + 1]
        ai = a_pad[:, jj:jj + W]                     # a[i - 1]
        sub = ((ai != bj) | (bj >= dna.INVALID_CODE)).to(torch.int32)
        up = torch.cat([dp[:, 1:], big], dim=1)
        new = torch.minimum(dp + sub, up + 1)
        # within-column dependency D[i-1][jj] + 1, in closed form
        new = torch.minimum(torch.cummin(new - slot, dim=1).values + slot,
                            scan_floor)
        valid_row = (rows >= 0) & (rows <= a_len[:, None])
        new = torch.where(valid_row, new, _BIG)
        dp = torch.where((jj <= b_len)[:, None], new, dp)
    w = band + (a_len - b_len)
    w_ok = (w >= 0) & (w < W)
    out = torch.gather(dp, 1, torch.clamp(w, 0, W - 1)[:, None].long())[:, 0]
    fallback = torch.abs(a_len - b_len) + torch.minimum(a_len, b_len)
    return torch.where(w_ok, torch.minimum(out, fallback), fallback)


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sfb_banded_ed.restype = i
    lib.sfb_banded_ed.argtypes = [p, p, p, p, i, i, i, p, p]
    lib.sfb_banded_ed_error.restype = ctypes.c_char_p
    lib.sfb_banded_ed_error.argtypes = [i]


class BandedEditDistanceKernel:
    """Callable wrapper of ``csrc/banded_ed.cu`` with the contract of
    ``banded_edit_distance_plain``. ``launches`` counts kernel launches
    (in ``launch``; CPU calls do not count)."""

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary("banded_ed.cu", _declare)

    def __call__(self, a, a_len, b, b_len, band: int = 32) -> torch.Tensor:
        if a.device.type == "cpu":
            return banded_edit_distance_plain(a, a_len, b, b_len, band)
        if a.device.type != "cuda":
            raise ValueError(f"unsupported device {a.device}")
        B, L = a.shape
        if (a.dtype != torch.uint8 or b.dtype != torch.uint8
                or tuple(b.shape) != (B, L)):
            raise ValueError("a and b must be (B, L) uint8 of one width")
        for x in (a_len, b_len):
            if (x.dtype != torch.int32 or tuple(x.shape) != (B,)
                    or x.device != a.device):
                raise ValueError(f"lengths must be ({B},) int32 on "
                                 f"{a.device}")
        if b.device != a.device:
            raise ValueError("a and b must be on one device")
        if not 0 <= band <= MAX_BAND:
            raise ValueError(f"band {band} outside 0..{MAX_BAND}")
        out = torch.empty(B, dtype=torch.int32, device=a.device)
        if B:
            self.launch(a.contiguous(), a_len.contiguous(), b.contiguous(),
                        b_len.contiguous(), band, out)
        return out

    def launch(self, a, a_len, b, b_len, band: int, out) -> None:
        """The bare launch on the current stream; ``__call__`` checks the
        inputs and allocates ``out`` before it comes here."""
        B, L = a.shape
        lib = self.library.load()
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.sfb_banded_ed(a.data_ptr(), a_len.data_ptr(),
                                    b.data_ptr(), b_len.data_ptr(), B, L,
                                    band, out.data_ptr(), stream)
        if err:
            raise RuntimeError("banded_ed launch failed: "
                               + lib.sfb_banded_ed_error(err).decode())
        self.launches += 1


banded_edit_distance = BandedEditDistanceKernel()
