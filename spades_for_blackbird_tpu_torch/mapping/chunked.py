"""Read-to-graph mapping over chunks of reads.

PyTorch counterpart of the JAX package's ``mapping/chunked.py``
(the reference streams reads through its mappers in chunks,
sequence_mapper_notifier.hpp:66): the (R, P) vote intermediates of one
``map_reads`` call stay bounded however large the library. A read's
mapping depends on that read alone, so the chunk size changes nothing in
the result. On the card the chunk is sized from the free memory
(``map_chunk_reads``); the JAX package's fixed-shape padding of the last
chunk, there to reuse one compile, is not needed: the last chunk is
shorter.
"""

from __future__ import annotations

import torch

from ..ops import dna
from ..utils import membudget
from ..utils.device import resolve_device
from . import mapper

# reads a chunk holds on the CPU (the JAX package's default chunk)
CPU_CHUNK_READS = 1 << 16


def map_chunk_reads(read_len: int, k: int, device: torch.device) -> int:
    """Reads one mapping chunk holds. A window holds at the peak its
    fused keys and strand byte, the search's rows and temporaries, its
    edge, offset and orientation, and, if it found its k-mer, its vote
    keys, position and sort permutation twice: about 256 + 16*ceil(W/2)
    bytes; a read's S = 8 candidate slots add 5 columns of 8 bytes each
    a few times over."""
    words = dna.words_per_kmer(k)
    per_read = (max(read_len - k + 1, 1) * (256 + 16 * ((words + 1) // 2))
                + 8 * 40 * 4)
    return membudget.reads_per_chunk(per_read, device, CPU_CHUNK_READS)


def _chunked(fn, index, seq_len, codes, lengths, k: int,
             chunk: int | None, device, out_type):
    """``fn(seq_len, codes, lengths)`` over chunks of reads, on the
    index's device (``device`` must name its kind)."""
    device = resolve_device(device, index.keys)
    if index.keys.device.type != device.type:
        raise ValueError(f"the index is on {index.keys.device}, the "
                         f"mapping was asked to run on {device}")
    device = index.keys.device
    seq_len = torch.as_tensor(seq_len).to(device)
    codes = torch.as_tensor(codes).to(device=device, dtype=torch.uint8)
    lengths = torch.as_tensor(lengths).to(device=device, dtype=torch.int32)
    if chunk is None:
        chunk = map_chunk_reads(codes.shape[1], k, device)
    R = codes.shape[0]
    if R <= chunk:
        return fn(seq_len, codes, lengths)
    parts = [fn(seq_len, codes[lo:lo + chunk], lengths[lo:lo + chunk])
             for lo in range(0, R, chunk)]
    return out_type(*(torch.cat(cols) for cols in zip(*parts)))


def map_reads_chunked(index, seq_len, codes, lengths, k: int,
                      chunk: int | None = None,
                      device=None) -> mapper.ReadMapping:
    """``mapper.map_reads`` over chunks of ``chunk`` reads. Runs on
    ``device`` (``resolve_device``: the card unless ``"cpu"`` is asked
    for), where ``index`` must lie; the reads are moved there."""
    return _chunked(
        lambda s, c, l: mapper.map_reads(index, s, c, l, k),
        index, seq_len, codes, lengths, k, chunk, device,
        mapper.ReadMapping)


def map_reads_multi_chunked(index, seq_len, codes, lengths, k: int,
                            max_placements: int = 4, min_votes: int = 2,
                            chunk: int | None = None,
                            device=None) -> mapper.ChainMapping:
    """``mapper.map_reads_multi`` over chunks of ``chunk`` reads."""
    return _chunked(
        lambda s, c, l: mapper.map_reads_multi(
            index, s, c, l, k, max_placements=max_placements,
            min_votes=min_votes),
        index, seq_len, codes, lengths, k, chunk, device,
        mapper.ChainMapping)
