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
``csrc/viterbi.cu`` (a warp a row up to 512 nodes, a block above, the
recursion over the row's positions in one launch); a failed build or
launch raises. Both take ``cdd = cumsum(tDD)`` from the host
(``cumulative_delete``), summed in float32 in order, so the card and the
CPU add the same numbers.

``ViterbiKernel.batched`` runs every profile of a ``ProfilePack``
(``pack_profiles``) over ragged rows (one buffer, row offsets and
lengths) in one entry call, with rows longest first; its plain version
``viterbi_batched_plain`` is a loop of ``viterbi_ends_plain`` over the
profiles on the rows padded to the longest. The one-profile call on a
padded (B, L) array is the same entry with rows at offsets r * L.
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
WARP_MAX_M = 512  # nodes of the warp path: 16 a lane
FREE_SHARE = 4  # a batched call's outputs take at most 1/4 of free memory


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
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sfb_viterbi_batched.restype = i
    lib.sfb_viterbi_batched.argtypes = [p, p, i, p, p, p, i, i, p, i, i, p,
                                        ll, p, p, p, i, ll, p, p, p,
                                        ctypes.POINTER(i)]
    lib.sfb_viterbi_error.restype = ctypes.c_char_p
    lib.sfb_viterbi_error.argtypes = [i]


@dataclass(frozen=True)
class ProfilePack:
    """Profiles concatenated along their nodes, on one device: what one
    batched Viterbi call takes. ``matchT`` (21, sum m) and ``trans`` (7,
    sum m: tMM, tMI, tMD, tIM, tII, tDM, cdd) float32; ``meta`` (P, 2)
    int32 (node offset, m) and ``tbm`` (P,) float32 beside them; the
    profiles of the warp path (m <= WARP_MAX_M, ``npl`` nodes a lane) and
    of the block path (``block_m`` their largest m) as int32 index
    tensors."""
    matchT: torch.Tensor
    trans: torch.Tensor
    meta: torch.Tensor
    tbm: torch.Tensor
    lengths: tuple
    warp_ids: torch.Tensor
    npl: int
    block_ids: torch.Tensor
    block_m: int

    @property
    def count(self) -> int:
        return len(self.lengths)

    def profile(self, p: int) -> tuple:
        """(match, tMM, tMI, tMD, tIM, tII, tDM, cdd) of profile ``p``:
        views of the pack, the arguments of ``viterbi_ends_plain``."""
        lo = int(sum(self.lengths[:p]))
        hi = lo + self.lengths[p]
        return (self.matchT[:, lo:hi].t(),) + tuple(self.trans[:, lo:hi])


def _nodes_a_lane(m: int) -> int:
    """Nodes a lane of the warp path holds for a profile of m nodes:
    ceil(m / 32), rounded up to even."""
    n = -(-m // 32)
    return n + n % 2


def _pack(matchT, trans, lengths, device) -> ProfilePack:
    def ids(sel):
        return torch.tensor(sel, dtype=torch.int32, device=device)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    warp = [p for p, m in enumerate(lengths) if m <= WARP_MAX_M]
    block = [p for p, m in enumerate(lengths) if m > WARP_MAX_M]
    return ProfilePack(
        matchT=matchT, trans=trans,
        meta=torch.tensor(np.stack([offsets, lengths], 1).astype(np.int32)
                          .reshape(-1, 2), device=device),
        tbm=torch.tensor([entry_score(m) for m in lengths],
                         dtype=torch.float32, device=device),
        lengths=tuple(int(m) for m in lengths),
        warp_ids=ids(warp),
        npl=max((_nodes_a_lane(lengths[p]) for p in warp), default=0),
        block_ids=ids(block),
        block_m=max((lengths[p] for p in block), default=0))


def pack_profiles(profiles, device) -> ProfilePack:
    """The profiles as one ``ProfilePack`` on ``device``."""
    lengths = [p.length for p in profiles]
    for m in lengths:
        if not 1 <= m <= MAX_M:
            raise ValueError(f"model length {m} outside 1..{MAX_M}")
    matchT = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [np.asarray(p.match, np.float32) for p in profiles]).T))
    trans = torch.from_numpy(np.stack([np.concatenate(
        [np.asarray(getattr(p, f), np.float32) for p in profiles])
        for f in ("tMM", "tMI", "tMD", "tIM", "tII", "tDM")]
        + [np.concatenate([cumulative_delete(p.tDD) for p in profiles])]))
    return _pack(matchT.to(device), trans.to(device), lengths, device)


def _padded_rows(seqs: torch.Tensor, row_off: torch.Tensor,
                row_len: torch.Tensor):
    """Ragged rows as a padded (B, max length) uint8 array (STOP past a
    row's end), with the flat positions of its cells and their mask."""
    L = int(row_len.max()) if len(row_len) else 0
    col = torch.arange(L, device=seqs.device)
    inside = col[None, :] < row_len[:, None]
    at = torch.where(inside, row_off[:, None] + col[None, :], 0)
    rows = torch.where(inside, seqs[at], STOP).to(torch.uint8)
    return rows, at, inside


def viterbi_batched_plain(pack: ProfilePack, seqs: torch.Tensor,
                          row_off: torch.Tensor, row_len: torch.Tensor):
    """Every profile of ``pack`` over ragged rows: seqs (N,) uint8 residues,
    row r at seqs[row_off[r] : row_off[r] + row_len[r]] (row_off (B,)
    int64, row_len (B,) int32). Returns (es, st), (P, N) float32 and int32:
    profile p's end scores and starts of row r at [p, row_off[r] + i],
    NEG and 0 at positions outside every row. ``viterbi_ends_plain`` a
    profile on the rows padded to the longest."""
    P, N = pack.count, seqs.shape[0]
    es = torch.full((P, N), NEG, dtype=torch.float32, device=seqs.device)
    st = torch.zeros((P, N), dtype=torch.int32, device=seqs.device)
    if not len(row_len) or not int(row_len.max()):
        return es, st
    rows, at, inside = _padded_rows(seqs, row_off, row_len)
    for p in range(P):
        e, s = viterbi_ends_plain(*pack.profile(p), rows, row_len,
                                  pack.lengths[p])
        es[p, at[inside]] = e[inside]
        st[p, at[inside]] = s[inside]
    return es, st


class ViterbiKernel:
    """Callable wrapper of ``csrc/viterbi.cu`` with the contract of
    ``viterbi_ends_plain``, except that positions at or past a row's
    length get start 0; ``batched`` has the contract of
    ``viterbi_batched_plain``. ``launches`` counts the kernels launched
    (in ``launch_batched``; CPU calls do not count): one a batch of
    profiles, two where it holds profiles of both paths."""

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
        matchT = match.t().contiguous().to(seqs.device, torch.float32)
        trans = torch.stack([tMM, tMI, tMD, tIM, tII, tDM, cdd]).to(
            seqs.device, torch.float32).contiguous()
        # the padded rows are ragged rows at offsets r * L
        row_off = torch.arange(B, dtype=torch.int64, device=seqs.device) * L
        es, st = self.batched(_pack(matchT, trans, [m], seqs.device),
                              seqs.reshape(-1), row_off,
                              lengths.clamp(0, L))
        return es.view(B, L), st.view(B, L)

    def batched(self, pack: ProfilePack, seqs: torch.Tensor,
                row_off: torch.Tensor, row_len: torch.Tensor):
        """Every profile of ``pack`` over ragged rows in one entry call;
        the contract of ``viterbi_batched_plain`` (which a CPU tensor
        takes)."""
        if seqs.device.type == "cpu":
            return viterbi_batched_plain(pack, seqs, row_off, row_len)
        if seqs.device.type != "cuda":
            raise ValueError(f"unsupported device {seqs.device}")
        if seqs.dtype != torch.uint8 or seqs.dim() != 1:
            raise ValueError("seqs must be (N,) uint8")
        B = row_len.shape[0]
        if (row_off.dtype != torch.int64 or row_len.dtype != torch.int32
                or tuple(row_off.shape) != (B,) or row_len.dim() != 1
                or row_off.device != seqs.device
                or row_len.device != seqs.device
                or pack.matchT.device != seqs.device):
            raise ValueError(f"row_off and row_len must be ({B},) int64 and "
                             f"int32, the pack on {seqs.device}")
        N = seqs.shape[0]
        if B and (int(row_len.min()) < 0 or int(row_off.min()) < 0
                  or int((row_off + row_len).max()) > N):
            raise ValueError("rows must lie inside seqs")
        if N and int(seqs.max()) > STOP:
            raise ValueError("amino-acid codes must be 0..20")
        es = torch.full((pack.count, N), NEG, dtype=torch.float32,
                        device=seqs.device)
        st = torch.zeros((pack.count, N), dtype=torch.int32,
                         device=seqs.device)
        if B and N:
            self.launch_batched(pack, _aligned(seqs), row_off.contiguous(),
                                row_len.contiguous(),
                                _longest_first(row_len), es, st)
        return es, st

    def launch_batched(self, pack: ProfilePack, seqs, row_off, row_len,
                       order, es, st) -> None:
        """The bare batched launch on the current stream, writing only
        the positions inside the rows; ``batched`` checks the inputs and
        allocates the outputs (P, N)."""
        lib = self.library.load()
        kernels = ctypes.c_int(0)
        with torch.cuda.device(seqs.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.sfb_viterbi_batched(
                pack.matchT.data_ptr(), pack.trans.data_ptr(),
                pack.matchT.shape[1], pack.meta.data_ptr(),
                pack.tbm.data_ptr(), pack.warp_ids.data_ptr(),
                len(pack.warp_ids), pack.npl, pack.block_ids.data_ptr(),
                len(pack.block_ids), pack.block_m, seqs.data_ptr(),
                seqs.numel(), row_off.data_ptr(), row_len.data_ptr(),
                order.data_ptr(), row_len.shape[0], es.shape[-1],
                es.data_ptr(), st.data_ptr(), stream, ctypes.byref(kernels))
        self.launches += kernels.value
        if err:
            raise RuntimeError("viterbi launch failed: "
                               + lib.sfb_viterbi_error(err).decode())


def _aligned(seqs: torch.Tensor) -> torch.Tensor:
    """``seqs`` contiguous at a 4-byte aligned address and a positive
    multiple of 4 bytes long, zero-padded where needed (the kernel reads
    4 residues a load)."""
    seqs = seqs.contiguous()
    n = seqs.numel()
    if seqs.data_ptr() % 4 == 0 and n % 4 == 0 and n:
        return seqs
    padded = torch.zeros(max(4, -(-n // 4) * 4), dtype=torch.uint8,
                         device=seqs.device)
    padded[:n] = seqs.reshape(-1)
    return padded


def _longest_first(lengths: torch.Tensor) -> torch.Tensor:
    """Row indices by descending length (int32): the kernel's order."""
    return torch.argsort(lengths, descending=True, stable=True).to(
        torch.int32)


viterbi_kernel = ViterbiKernel()


def profiles_per_launch(positions: int, n_profiles: int, device) -> int:
    """Profiles one batched call takes: on the card, as many whose outputs
    (8 bytes a position) fit ``1/FREE_SHARE`` of its free memory; on the
    CPU one, so the host holds one profile's outputs at a time."""
    if device.type != "cuda":
        return 1
    free, _ = torch.cuda.mem_get_info(device)
    return max(1, min(n_profiles,
                      free // FREE_SHARE // max(1, 8 * positions)))


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
