"""Build and load the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C
interface. At first use it is compiled with ``nvcc`` for ``sm_90a`` into
the package's ``build/`` directory (git-ignored), under a name that
carries a hash of the source and the flags, and loaded through
``ctypes``. The compiler writes to a temporary name that is renamed into
place, so a process never loads a library another one is still writing.
A missing ``nvcc`` or a failed build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
                       "the port's CUDA kernels cannot be built")


class CudaLibrary:
    """One kernel source and the shared library built from it.

    ``declare(lib)`` sets the argument and result types of the library's
    C functions once it is loaded. ``build_seconds`` and ``ptxas_log``
    describe the last build (0 and "" when the library was there).
    """

    def __init__(self, source_name: str, declare, extra_flags=()):
        self.source = os.path.join(CSRC_DIR, source_name)
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self.declare = declare
        self.build_seconds = 0.0
        self.ptxas_log = ""
        self._lib = None

    def library_path(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha1(f.read() + " ".join(self.flags).encode())
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR,
                            f"lib{stem}_{digest.hexdigest()[:12]}.so")

    def build(self) -> str:
        """Compile the source unless its library exists; its path."""
        so = self.library_path()
        if os.path.exists(so):
            return so
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.{id(self)}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *self.flags, "-o", tmp, self.source],
                              capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.ptxas_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {os.path.basename(self.source)} with exit "
                f"code {proc.returncode}:\n{self.ptxas_log}")
        os.replace(tmp, so)
        return so

    def load(self):
        """The loaded library (built first where needed)."""
        if self._lib is None:
            lib = ctypes.CDLL(self.build())
            self.declare(lib)
            self._lib = lib
        return self._lib


def build_all(libraries) -> None:
    """Build several libraries at once: one ``nvcc`` for each source,
    all started together."""
    libraries = list(libraries)
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        for future in [pool.submit(lib.build) for lib in libraries]:
            future.result()
