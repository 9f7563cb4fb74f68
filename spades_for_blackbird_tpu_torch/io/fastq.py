"""Host-side FASTA/FASTQ (optionally gzipped) -> padded code arrays.

The port's own copy of the JAX package's ``io/fastq.py`` (the
reference's kseq-based read streams and binary read store,
assembler/src/common/io/reads/fasta_fastq_gz_parser.hpp,
io/reads/binary_converter.hpp:25): reads are parsed once on the host into
dense uint8 NumPy code arrays ready for the transfer to the device;
re-streaming is just re-slicing the array. The native C++ reader
(``native/``) parses where a toolchain built it, the Python parser below
elsewhere; both give identical arrays.
"""

from __future__ import annotations

import gzip
import io as _io
from dataclasses import dataclass

import numpy as np

from ..ops import dna


@dataclass
class ReadBatch:
    """A batch of reads as padded device-ready arrays."""
    codes: np.ndarray     # (R, L) uint8, INVALID_CODE padding
    lengths: np.ndarray   # (R,) int32
    names: list[str] | None = None
    quals: np.ndarray | None = None   # (R, L) uint8 raw phred+33, 0 pad

    @property
    def num_reads(self) -> int:
        return self.codes.shape[0]

    @property
    def max_len(self) -> int:
        return self.codes.shape[1]


def _open_text(path: str):
    if str(path).endswith(".gz"):
        return _io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def read_sequences(path: str) -> tuple[list[str], list[str]]:
    """Parse FASTA or FASTQ (.gz ok) -> (names, sequences)."""
    names: list[str] = []
    seqs: list[str] = []
    with _open_text(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == ">":  # FASTA
            cur: list[str] = []
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                if line.startswith(">"):
                    if cur:
                        seqs.append("".join(cur))
                        cur = []
                    names.append(line[1:].split()[0] if len(line) > 1 else "")
                else:
                    cur.append(line)
            if cur:
                seqs.append("".join(cur))
        elif first == "@":  # FASTQ
            while True:
                header = f.readline()
                if not header:
                    break
                seq = f.readline().rstrip()
                f.readline()  # '+'
                f.readline()  # quality
                names.append(header[1:].rstrip().split()[0])
                seqs.append(seq)
        elif first == "":
            pass
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")
    return names, seqs


def peek_read_length(path: str, n: int = 100) -> int:
    """Max length of the first ``n`` reads (for K-ladder selection,
    mirroring the reference's read-length scan in support.py)."""
    longest = 0
    count = 0
    with _open_text(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == ">":
            cur = 0
            for line in f:
                line = line.rstrip()
                if line.startswith(">"):
                    longest = max(longest, cur)
                    cur = 0
                    count += 1
                    if count > n:
                        break
                else:
                    cur += len(line)
            longest = max(longest, cur)
        elif first == "@":
            while count < n:
                h = f.readline()
                if not h:
                    break
                longest = max(longest, len(f.readline().rstrip()))
                f.readline()
                f.readline()
                count += 1
    return longest


def load_reads(path: str, max_len: int | None = None,
               keep_names: bool = False,
               with_quals: bool = False) -> ReadBatch:
    if not keep_names and max_len is None:
        # hot path: native zlib parser packing straight into the array
        from .. import native
        want_quals = with_quals
        if want_quals:
            with _open_text(path) as fh:
                first = fh.read(1)
            want_quals = first == "@"  # FASTA has no qualities
        out = native.load_reads_native(path, with_quals=want_quals)
        if out is not None:
            if want_quals:
                return ReadBatch(out[0], out[1], None, out[2])
            return ReadBatch(out[0], out[1], None)
    names, seqs = read_sequences(path)
    codes, lengths = dna.encode_reads(seqs, max_len=max_len)
    quals = None
    if with_quals:
        qs = _read_qualities(path)
        if qs is not None:
            quals = np.zeros_like(codes)
            for i, q in enumerate(qs):
                arr = np.frombuffer(q.encode(), np.uint8)[:codes.shape[1]]
                quals[i, :len(arr)] = arr
    return ReadBatch(codes, lengths, names if keep_names else None, quals)


def _read_qualities(path: str) -> list[str] | None:
    """FASTQ quality strings (None for FASTA)."""
    with _open_text(path) as f:
        first = f.readline()
        if not first or not first.startswith("@"):
            return None
        out = []
        f.seek(0)
        while True:
            if not f.readline():
                break
            f.readline()
            f.readline()
            q = f.readline()
            if not q:
                break
            out.append(q.rstrip())
        return out


def load_paired_reads(left: str, right: str, max_len: int | None = None,
                      with_quals: bool = False
                      ) -> tuple[ReadBatch, ReadBatch]:
    """Load a paired-end library (two mate files, same read count/order)."""
    lb = load_reads(left, max_len=max_len, with_quals=with_quals)
    rb = load_reads(right, max_len=max_len, with_quals=with_quals)
    if lb.num_reads != rb.num_reads:
        raise ValueError(
            f"paired files disagree: {lb.num_reads} vs {rb.num_reads} reads")
    L = max(lb.max_len, rb.max_len)
    for b in (lb, rb):
        if b.max_len < L:
            pad = np.full((b.num_reads, L - b.max_len), dna.INVALID_CODE,
                          dtype=np.uint8)
            if b.quals is not None:
                b.quals = np.concatenate(
                    [b.quals, np.zeros_like(pad)], axis=1)
            b.codes = np.concatenate([b.codes, pad], axis=1)
    return lb, rb


def write_reads_fastq(path: str, codes, lengths, prefix: str = "read"
                      ) -> None:
    """Write a read batch as FASTQ (constant quality; the corrected-read
    output of the error-correction stage, mirroring the reference's
    corrected/*.fastq output)."""
    codes = np.asarray(codes)
    lengths = np.asarray(lengths)
    tag = prefix.encode()
    with (gzip.open(path, "wb") if str(path).endswith(".gz")
          else open(path, "wb")) as f:
        for lo in range(0, codes.shape[0], 1 << 16):
            # bases of a slab of reads as ASCII, one row a read
            text = dna.CODE_TO_CHAR[np.minimum(codes[lo:lo + (1 << 16)],
                                               dna.INVALID_CODE)]
            quality = b"I" * text.shape[1]
            f.write(b"".join(
                b"@%s_%d\n%s\n+\n%s\n" % (tag, lo + i, row.tobytes()[:n],
                                         quality[:n])
                for i, (row, n) in enumerate(
                    zip(text, lengths[lo:lo + (1 << 16)].tolist()))))


def concat_batches(batches: list[ReadBatch]) -> ReadBatch:
    L = max(b.max_len for b in batches)
    quals = None
    if batches and all(b.quals is not None for b in batches):
        qs = []
        for b in batches:
            q = b.quals
            if q.shape[1] < L:
                q = np.concatenate(
                    [q, np.zeros((q.shape[0], L - q.shape[1]), np.uint8)],
                    axis=1)
            qs.append(q)
        quals = np.concatenate(qs, axis=0)
    codes = []
    for b in batches:
        c = b.codes
        if c.shape[1] < L:
            pad = np.full((c.shape[0], L - c.shape[1]), dna.INVALID_CODE,
                          dtype=np.uint8)
            c = np.concatenate([c, pad], axis=1)
        codes.append(c)
    return ReadBatch(np.concatenate(codes, axis=0),
                     np.concatenate([b.lengths for b in batches]),
                     None, quals)
