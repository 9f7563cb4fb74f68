"""Native (C++) host components of the port, loaded via ctypes.

The compute path is PyTorch and CUDA; data ingest around it is C++ like
the reference's. ``fastq_reader.cpp`` (the port's own copy) builds with
``g++`` at first use into the package's ``build/`` directory; where there
is no toolchain ``get_lib`` returns None and the callers in ``io/`` take
their pure-Python parsers, which give identical arrays. Which reader runs
is logged once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..utils.logger import get_logger

_log = get_logger("ReadIO")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fastq_reader.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_tried = False


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libfastq_reader_{digest.hexdigest()[:12]}.so")


def _build(so: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, SOURCE, "-lz", "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        return False
    os.replace(tmp, so)
    return True


def _declare(lib) -> None:
    i64, p = ctypes.c_int64, ctypes.c_void_p
    i64p = ctypes.POINTER(ctypes.c_int64)
    for name, argtypes in (
            ("sfb_scan", [ctypes.c_char_p, i64p]),
            ("sfb_fill", [ctypes.c_char_p, p, p, p, i64, i64]),
            ("sfb_store_convert", [ctypes.c_char_p, ctypes.c_char_p, i64]),
            ("sfb_store_info", [ctypes.c_char_p, i64p, i64p, i64p]),
            ("sfb_store_load_chunk",
             [ctypes.c_char_p, i64, p, p, i64, i64])):
        fn = getattr(lib, name)
        fn.restype = i64
        fn.argtypes = argtypes


def get_lib():
    """The native library handle, or None (pure-Python readers)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = library_path()
    try:
        if os.path.exists(so) or _build(so):
            lib = ctypes.CDLL(so)
            _declare(lib)
            _lib = lib
    except OSError:
        _lib = None
    _log.info("read input through the native C++ reader" if _lib is not None
              else "no g++ or zlib here: read input through the Python "
                   "parser")
    return _lib


def load_reads_native(path: str, with_quals: bool = False):
    """Parse FASTA/FASTQ(.gz) into (codes, lengths[, quals]) NumPy arrays
    using the native reader. Returns None if the native lib is absent."""
    lib = get_lib()
    if lib is None:
        return None
    max_len = ctypes.c_int64(0)
    n = lib.sfb_scan(path.encode(), ctypes.byref(max_len))
    if n < 0:
        raise IOError(f"native reader failed to parse {path}")
    R, L = int(n), max(int(max_len.value), 1)
    codes = np.empty((R, L), dtype=np.uint8)
    lengths = np.empty((R,), dtype=np.int32)
    quals = np.empty((R, L), dtype=np.uint8) if with_quals else None
    filled = lib.sfb_fill(path.encode(), codes.ctypes.data, lengths.ctypes.data,
                          quals.ctypes.data if with_quals else None, R, L)
    if filled != R:
        raise IOError(f"native reader: expected {R} reads, got {filled}")
    if with_quals:
        return codes, lengths, quals
    return codes, lengths
