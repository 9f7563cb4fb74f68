"""Batched profile-HMM Viterbi.

PyTorch counterpart of the JAX package's ``ops/hmm.py`` (the vendored
HMMER pipeline used by biosyntheticSPAdes, ``hmmer::HMMMatcher`` in
common/hmm/hmmmatcher.cpp, driven by projects/spades/domain_matcher.cpp):
a plan7-style local Viterbi whose every state carries the start of its
best path, so the per-position outputs (end score, start) give every
candidate domain hit without a traceback.

``viterbi_ends`` dispatches on the device of the rows. A CPU tensor goes
to ``viterbi_ends_plain``, which steps over the positions in PyTorch with
the JAX package's float32 operations in its order (the delete chain's
max-plus scan as ``torch.cummax``, whose ties go to the later node as
the JAX package's combine does). A CUDA tensor launches the hand kernel
``csrc/viterbi.cu`` (one block a row, the recursion over the row's
positions in one launch); a failed build or launch raises. Both take
``cdd = cumsum(tDD)`` from the host (``cumulative_delete``), summed in
float32 in order, so the card and the CPU add the same numbers.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .aa import NUM_AA, STOP
from .cuda_build import CudaLibrary

NEG = -1.0e30
MAX_M = 2048  # nodes the kernel takes: two a thread, 1024 threads


@dataclass(frozen=True)
class HMMProfile:
    """Log-odds profile (natural log, vs background).

    match: (m, 21) match emission scores (col 20 = stop codon, -inf).
    t: (m,) transition score arrays tMM/tMI/tMD/tIM/tII/tDM/tDD, where
       index j is the transition out of node j+1 (1-based nodes,
       trailing entries unused where n/a).
    name/desc/length: model metadata.
    """
    name: str
    match: np.ndarray
    tMM: np.ndarray
    tMI: np.ndarray
    tMD: np.ndarray
    tIM: np.ndarray
    tII: np.ndarray
    tDM: np.ndarray
    tDD: np.ndarray
    desc: str = ""

    @property
    def length(self) -> int:
        return self.match.shape[0]


def hmm_from_consensus(name: str, aa_codes, match_p: float = 0.9,
                       t_stay: float = 0.05) -> HMMProfile:
    """Build a simple profile from a consensus AA sequence (for tests and
    synthetic domain models): each node emits its consensus residue with
    probability ``match_p``, the rest uniform."""
    aa_codes = np.asarray(aa_codes)
    m = len(aa_codes)
    bg = 1.0 / NUM_AA
    other = (1.0 - match_p) / (NUM_AA - 1)
    match = np.full((m, NUM_AA + 1), np.log(other / bg), np.float32)
    match[np.arange(m), aa_codes] = np.log(match_p / bg)
    match[:, STOP] = NEG
    t_go = 1.0 - 2 * t_stay
    z = np.full(m, np.log(t_go), np.float32)
    stay = np.full(m, np.log(t_stay), np.float32)
    return HMMProfile(name=name, match=match,
                      tMM=z, tMI=stay, tMD=stay,
                      tIM=np.full(m, np.log(0.5), np.float32),
                      tII=np.full(m, np.log(0.5), np.float32),
                      tDM=np.full(m, np.log(0.5), np.float32),
                      tDD=np.full(m, np.log(0.5), np.float32))


def entry_score(m: int) -> np.float32:
    """Uniform local entry, log(1/m), as the JAX package rounds it."""
    return np.float32(-np.log(m))


def cumulative_delete(tDD) -> np.ndarray:
    """cumsum(tDD) in float32, summed in order on the host."""
    return np.cumsum(np.asarray(tDD, np.float32), dtype=np.float32)


def _shift1(x: torch.Tensor, fill) -> torch.Tensor:
    """x moved one node to the right along the last axis, ``fill`` first."""
    return torch.nn.functional.pad(x[..., :-1], (1, 0), value=fill)


def viterbi_ends_plain(match, tMM, tMI, tMD, tIM, tII, tDM, cdd,
                       seqs: torch.Tensor, lengths: torch.Tensor, m: int):
    """Local Viterbi over a batch of AA rows: seqs (B, L) uint8 (20 =
    stop), lengths (B,). Parameters are float32 tensors on the rows'
    device, ``cdd`` from ``cumulative_delete``. Returns (end_scores
    (B, L) float32, end_starts (B, L) int32): the best local-alignment
    score of a path ending at each position, and its start. Positions at
    or past a row's length keep the state and score NEG."""
    B, L = seqs.shape
    dev = seqs.device
    tBM = torch.tensor(entry_score(m), device=dev)
    VM = torch.full((B, m), NEG, dtype=torch.float32, device=dev)
    VI = VM.clone()
    VD = VM.clone()
    SM = torch.zeros((B, m), dtype=torch.int32, device=dev)
    SI = SM.clone()
    SD = SM.clone()
    es = torch.empty((B, L), dtype=torch.float32, device=dev)
    st = torch.empty((B, L), dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    cdd_shift = _shift1(cdd, 0.0)
    for i in range(L):
        a = seqs[:, i].long()
        valid = (i < lengths)[:, None]
        me = match.t()[a]                                   # (B, m)
        pm = _shift1(VM + tMM, NEG)
        pi = _shift1(VI + tIM, NEG)
        pd = _shift1(VD + tDM, NEG)
        # argmax over (entry, pm, pi, pd), the first on ties
        best = tBM.expand(B, m)
        start = torch.full((B, m), i, dtype=torch.int32, device=dev)
        for cand, cst in ((pm, _shift1(SM, 0)), (pi, _shift1(SI, 0)),
                          (pd, _shift1(SD, 0))):
            gt = cand > best
            best = torch.where(gt, cand, best)
            start = torch.where(gt, cst, start)
        VMn = me + best
        SMn = start
        im = VM + tMI
        ii = VI + tII
        ie = torch.where(a == STOP, NEG, 0.0).to(torch.float32)[:, None]
        VIn = ie + torch.maximum(im, ii)
        SIn = torch.where(im >= ii, SM, SI)
        # delete chain: max-plus prefix scan, ties to the later node
        run_s, run_at = torch.cummax((VMn + tMD) - cdd, dim=1)
        run_i = torch.gather(SMn, 1, run_at)
        VDn = _shift1(run_s, NEG) + cdd_shift
        SDn = _shift1(run_i, 0)
        j = torch.argmax(VMn, dim=1)
        es[:, i] = torch.where(valid[:, 0], VMn[rows, j], NEG)
        st[:, i] = SMn[rows, j]
        VM = torch.where(valid, VMn, VM)
        VI = torch.where(valid, VIn, VI)
        VD = torch.where(valid, VDn, VD)
        SM = torch.where(valid, SMn, SM)
        SI = torch.where(valid, SIn, SI)
        SD = torch.where(valid, SDn, SD)
    return es, st


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sfb_viterbi.restype = i
    lib.sfb_viterbi.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, p, p,
                                p]
    lib.sfb_viterbi_error.restype = ctypes.c_char_p
    lib.sfb_viterbi_error.argtypes = [i]


class ViterbiKernel:
    """Callable wrapper of ``csrc/viterbi.cu`` with the contract of
    ``viterbi_ends_plain``, except that positions at or past a row's
    length get start 0. ``launches`` counts kernel launches (in
    ``launch``; CPU calls do not count)."""

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary("viterbi.cu", _declare,
                                   extra_flags=("--fmad=false",))

    def __call__(self, match, tMM, tMI, tMD, tIM, tII, tDM, cdd,
                 seqs: torch.Tensor, lengths: torch.Tensor, m: int):
        if seqs.device.type == "cpu":
            return viterbi_ends_plain(match, tMM, tMI, tMD, tIM, tII, tDM,
                                      cdd, seqs, lengths, m)
        if seqs.device.type != "cuda":
            raise ValueError(f"unsupported device {seqs.device}")
        B, L = seqs.shape
        if seqs.dtype != torch.uint8 or seqs.dim() != 2:
            raise ValueError("seqs must be (B, L) uint8")
        if (lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,)
                or lengths.device != seqs.device):
            raise ValueError(f"lengths must be ({B},) int32 on "
                             f"{seqs.device}")
        if not 1 <= m <= MAX_M:
            raise ValueError(f"model length {m} outside 1..{MAX_M}")
        if tuple(match.shape) != (m, NUM_AA + 1):
            raise ValueError(f"match must be ({m}, {NUM_AA + 1})")
        if B and L and int(seqs.max()) > STOP:
            raise ValueError("amino-acid codes must be 0..20")
        matchT = match.t().contiguous().to(seqs.device, torch.float32)
        trans = torch.stack([tMM, tMI, tMD, tIM, tII, tDM, cdd]).to(
            seqs.device, torch.float32).contiguous()
        es = torch.empty((B, L), dtype=torch.float32, device=seqs.device)
        st = torch.empty((B, L), dtype=torch.int32, device=seqs.device)
        if B and L:
            self.launch(matchT, trans, seqs.contiguous(),
                        lengths.contiguous(), m, es, st)
        return es, st

    def launch(self, matchT, trans, seqs, lengths, m: int, es, st) -> None:
        """The bare launch on the current stream: ``matchT`` (21, m) and
        ``trans`` (7, m: tMM, tMI, tMD, tIM, tII, tDM, cdd) float32;
        ``__call__`` checks the inputs and allocates the outputs."""
        B, L = seqs.shape
        lib = self.library.load()
        with torch.cuda.device(seqs.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.sfb_viterbi(
                matchT.data_ptr(), trans.data_ptr(), seqs.data_ptr(),
                lengths.data_ptr(), B, L, m, float(entry_score(m)),
                es.data_ptr(), st.data_ptr(), stream)
        if err:
            raise RuntimeError("viterbi launch failed: "
                               + lib.sfb_viterbi_error(err).decode())
        self.launches += 1


viterbi_kernel = ViterbiKernel()


def profile_tensors(profile: HMMProfile, device) -> tuple:
    """(match, tMM, tMI, tMD, tIM, tII, tDM, cdd) float32 on ``device``."""
    def put(x):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x, np.float32))).to(device)
    return tuple(put(x) for x in (
        profile.match, profile.tMM, profile.tMI, profile.tMD, profile.tIM,
        profile.tII, profile.tDM, cumulative_delete(profile.tDD)))


def viterbi_ends(match, tMM, tMI, tMD, tIM, tII, tDM, tDD,
                 seqs: torch.Tensor, lengths: torch.Tensor, m: int):
    """The JAX package's signature: float32 parameter tensors (``tDD``,
    not its cumulative sum) on the rows' device; (end_scores,
    end_starts) there, through the kernel on a card."""
    cdd = torch.from_numpy(cumulative_delete(tDD.cpu().numpy())).to(
        seqs.device)
    return viterbi_kernel(match, tMM, tMI, tMD, tIM, tII, tDM, cdd, seqs,
                          lengths, m)


def score_batch(profile: HMMProfile, seqs: np.ndarray, lengths: np.ndarray,
                device=None):
    """Convenience wrapper: numpy in, numpy (end_scores, end_starts) out;
    runs on ``device`` (``resolve_device``: the card unless ``"cpu"`` is
    asked for)."""
    from ..utils.device import resolve_device
    device = resolve_device(device)
    s = torch.from_numpy(np.ascontiguousarray(seqs, np.uint8)).to(device)
    ln = torch.from_numpy(np.ascontiguousarray(lengths, np.int32)).to(device)
    es, st = viterbi_kernel(*profile_tensors(profile, device), s, ln,
                            profile.length)
    return es.cpu().numpy(), st.cpu().numpy()


def find_hits(end_scores: np.ndarray, end_starts: np.ndarray, length: int,
              threshold: float, min_span: int = 1):
    """Greedy non-overlapping hit selection for ONE sequence:
    [(aa_start, aa_end_inclusive, score), ...] sorted by position."""
    es = end_scores[:length]
    order = np.argsort(-es)
    taken: list[tuple[int, int, float]] = []
    for pos in order:
        s = float(es[pos])
        if s < threshold:
            break
        a, b = int(end_starts[pos]), int(pos)
        if b - a + 1 < min_span:
            continue
        if any(not (b < ta or a > tb) for ta, tb, _ in taken):
            continue
        taken.append((a, b, s))
    taken.sort()
    return taken
