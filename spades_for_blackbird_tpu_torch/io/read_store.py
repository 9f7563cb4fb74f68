"""Disk-backed binary read store (chunked re-streaming).

The port's own copy of the JAX package's ``io/read_store.py``
(the reference's binary read store, io/reads/binary_converter.hpp:25
``BinaryWriter`` + io/dataset_support/read_converter.hpp:25
``ReadConverter``): convert FASTQ/FASTA(.gz) once into packed 2-bit
chunks on disk, then load any chunk as a device-ready array without
holding the whole dataset in RAM. The converter and chunk loader are
native C++ (native/fastq_reader.cpp, store section); a NumPy version
covers machines without a toolchain and writes the same bytes.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np
import torch

from .. import native
from ..kmers import counter
from ..ops import dna
from ..utils.device import resolve_device

_MAGIC = 0x4642545053544F52


class ReadStore:
    def __init__(self, path: str):
        self.path = path
        lib = native.get_lib()
        if lib is not None:
            nr = ctypes.c_int64()
            ml = ctypes.c_int64()
            cr = ctypes.c_int64()
            rc = lib.sfb_store_info(path.encode(), ctypes.byref(nr),
                                    ctypes.byref(ml), ctypes.byref(cr))
            if rc != 0:
                raise ValueError(f"{path}: not a read store")
            self.num_reads = nr.value
            self.max_len = ml.value
            self.chunk_reads = cr.value
        else:
            with open(path, "rb") as f:
                magic, nr, ml, cr, _ = struct.unpack("<QQQQQ", f.read(40))
            if magic != _MAGIC:
                raise ValueError(f"{path}: not a read store")
            self.num_reads, self.max_len, self.chunk_reads = nr, ml, cr

    @property
    def num_chunks(self) -> int:
        if self.num_reads == 0:
            return 0
        return -(-self.num_reads // self.chunk_reads)

    @classmethod
    def convert(cls, fastq_paths: list[str], store_path: str,
                chunk_reads: int = 1 << 20) -> "ReadStore":
        lib = native.get_lib()
        if lib is not None:
            n = lib.sfb_store_convert(";".join(fastq_paths).encode(),
                                      store_path.encode(), chunk_reads)
            if n < 0:
                raise IOError(f"store conversion failed for {fastq_paths}")
            return cls(store_path)
        return cls._convert_py(fastq_paths, store_path, chunk_reads)

    @classmethod
    def _convert_py(cls, fastq_paths, store_path, chunk_reads):
        from . import fastq
        index = []
        n_reads = 0
        max_len = 0
        with open(store_path, "wb") as f:
            f.write(struct.pack("<QQQQQ", _MAGIC, 0, 0, chunk_reads, 0))
            for p in fastq_paths:
                b = fastq.load_reads(p)
                for r in range(b.num_reads):
                    if n_reads % chunk_reads == 0:
                        index.append(f.tell())
                    ln = int(b.lengths[r])
                    codes = np.asarray(b.codes[r, :ln]).copy()
                    codes[codes > 3] = 0
                    f.write(struct.pack("<I", ln))
                    packed = np.zeros((ln + 3) // 4, np.uint8)
                    for i in range(ln):
                        packed[i >> 2] |= np.uint8(codes[i] << ((i & 3) * 2))
                    f.write(packed.tobytes())
                    n_reads += 1
                    max_len = max(max_len, ln)
            index_off = f.tell()
            f.write(np.asarray(index, np.uint64).tobytes())
            f.seek(0)
            f.write(struct.pack("<QQQQQ", _MAGIC, n_reads, max_len,
                                chunk_reads, index_off))
        return cls(store_path)

    def load_chunk(self, chunk_idx: int):
        """-> (codes (R, max_len) uint8 padded with 4, lengths (R,) i32);
        the tail chunk is padded to chunk_reads rows with reads of length
        0."""
        R = self.chunk_reads
        L = max(self.max_len, 1)
        codes = np.full((R, L), dna.INVALID_CODE, np.uint8)
        lengths = np.zeros(R, np.int32)
        lib = native.get_lib()
        if lib is not None:
            n = lib.sfb_store_load_chunk(self.path.encode(), chunk_idx,
                                         codes.ctypes.data,
                                         lengths.ctypes.data, R, L)
            if n < 0:
                raise IOError(f"chunk {chunk_idx} load failed")
            return codes, lengths
        return self._load_chunk_py(chunk_idx, codes, lengths)

    def _load_chunk_py(self, chunk_idx, codes, lengths):
        with open(self.path, "rb") as f:
            f.seek(40 - 8)
            (index_off,) = struct.unpack("<Q", f.read(8))
            f.seek(index_off + 8 * chunk_idx)
            (off,) = struct.unpack("<Q", f.read(8))
            f.seek(off)
            first = chunk_idx * self.chunk_reads
            count = min(self.num_reads - first, self.chunk_reads)
            for r in range(count):
                (ln,) = struct.unpack("<I", f.read(4))
                packed = np.frombuffer(f.read((ln + 3) // 4), np.uint8)
                idx = np.arange(ln)
                codes[r, :ln] = (packed[idx >> 2] >> ((idx & 3) * 2)) & 3
                lengths[r] = ln
        return codes, lengths


def count_kmers_store(store: ReadStore, k: int,
                      device: str | torch.device | None = None
                      ) -> counter.KmerTable:
    """Chunked canonical k-mer counting straight off the store, one
    extraction a chunk: the out-of-core path for datasets larger than
    device memory (the role of the reference's disk-bucket counter).
    Runs on the card unless ``device="cpu"`` is passed, and raises where
    there is no card."""
    device = resolve_device(device)
    table = None
    for ci in range(store.num_chunks):
        codes, lengths = store.load_chunk(ci)
        part = counter.trim_table(counter.count_kmers(
            torch.from_numpy(codes).to(device),
            torch.from_numpy(lengths).to(device), k))
        table = part if table is None else counter.trim_table(
            counter.merge_tables(table, part))
    return table
