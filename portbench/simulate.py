"""The benchmark's read simulators: frozen NumPy copies.

``random_genome`` is ``utils/simulate.py::random_genome``; ``paired_codes``
is ``chip_smoke.py::paired_codes`` (the 4.6 Mb isolate's reads, the same
random numbers as ``utils/simulate.py::simulate_paired_reads``). They are
copied, not imported, so that a change to the program cannot change the
benchmark's inputs, and they import nothing of the program.

``simulate(config, seed)`` is the one generator a configuration file
drives: the genome from the configuration's seed, the reads from the run's.
"""

from __future__ import annotations

import gzip
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)
CHAR_TO_CODE = np.full(256, 4, np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    CHAR_TO_CODE[_ch] = _i
CODE_TO_CHAR = np.frombuffer(b"ACGTN", dtype=np.uint8)
_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP[_a] = _b


@dataclass
class Reads:
    """A simulated paired library: first mates then second mates.

    ``codes`` (2n, L) uint8 0..3 with the errors, ``quals`` the phred+33
    bytes, ``truth`` the codes without the errors; ``sources`` maps the
    genome's name to its bases (str)."""
    codes: np.ndarray
    quals: np.ndarray
    truth: np.ndarray
    sources: dict

    @property
    def pairs(self) -> int:
        return self.codes.shape[0] // 2


def seed_for(seed: int, purpose: int) -> np.random.SeedSequence:
    """A stream of its own for each use of one run seed."""
    return np.random.SeedSequence([int(seed) & (2**64 - 1), purpose])


def random_genome(length: int, seed: int = 0, repeats=None,
                  gc: float = 0.5) -> str:
    """Random genome with planted exact repeats: ``repeats`` lists
    (repeat_len, n_copies); each repeat is drawn once and written at
    random non-overlapping positions."""
    rng = np.random.default_rng(seed)
    p_gc = gc / 2.0
    p_at = (1.0 - gc) / 2.0
    arr = rng.choice(ALPHA, size=length, p=[p_at, p_gc, p_gc, p_at])
    if repeats:
        taken: list[tuple[int, int]] = []
        for rep_len, copies in repeats:
            unit = rng.choice(ALPHA, size=rep_len)
            placed = 0
            attempts = 0
            while placed < copies and attempts < 1000:
                attempts += 1
                pos = int(rng.integers(0, length - rep_len))
                if any(pos < e and pos + rep_len > s for s, e in taken):
                    continue
                arr[pos:pos + rep_len] = unit
                taken.append((pos, pos + rep_len))
                placed += 1
    return arr.tobytes().decode("ascii")


def paired_codes(genome: str, n_pairs: int, read_len: int,
                 insert_mean: float, insert_sd: float, error_rate: float,
                 seed):
    """FR pairs over ``genome``: (codes (2n, L) uint8, first mates then
    second mates; their phred+33 qualities; the codes without errors)."""
    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome.encode("ascii"), dtype=np.uint8)
    L = len(g)
    ins = np.clip(rng.normal(insert_mean, insert_sd, n_pairs).astype(int),
                  read_len, None)
    start = rng.integers(0, np.maximum(L - ins, 1), n_pairs)
    fwd = rng.random(n_pairs) < 0.5
    offs = np.arange(read_len)
    r1 = g[np.minimum(start[:, None] + offs[None, :], L - 1)]
    r2 = g[np.minimum(start[:, None] + (ins - read_len)[:, None]
                      + offs[None, :], L - 1)]
    r2 = _COMP[r2[:, ::-1]]
    r1, r2 = (np.where(fwd[:, None], r1, _COMP[r2[:, ::-1]]),
              np.where(fwd[:, None], r2, _COMP[r1[:, ::-1]]))
    true_reads = np.concatenate([r1, r2])

    def add_errors(reads):
        err = rng.random(reads.shape) < error_rate
        shift = rng.integers(1, 4, reads.shape)
        reads = reads.copy()
        reads[err] = ALPHA[(CHAR_TO_CODE[reads[err]].astype(np.int64)
                            + shift[err]) % 4]
        qual = np.where(rng.random(reads.shape) < 0.01, 12, 38).astype(
            np.uint8)
        qual[err & (rng.random(reads.shape) < 0.7)] = 8
        return reads, qual + 33

    r1, q1 = add_errors(r1)
    r2, q2 = add_errors(r2)
    return (CHAR_TO_CODE[np.concatenate([r1, r2])],
            np.concatenate([q1, q2]).astype(np.uint8),
            CHAR_TO_CODE[true_reads])


def simulate(cfg: dict, seed: int, scale: float = 1.0) -> Reads:
    """The configuration's library: its genome from the configuration's
    own seed (the one organism of the deployment), the reads (fragments,
    strands, errors, qualities) from ``seed``, so that each seed is
    another sample of it. ``scale`` cuts the genome and the pairs alike
    (the warm-up job), keeping the coverage."""
    lib = cfg["library"]
    (src,) = cfg["sources"]
    genome = random_genome(int(src["length"] * scale), seed=src["seed"],
                           repeats=src.get("repeats"), gc=src.get("gc", 0.5))
    codes, quals, truth = paired_codes(
        genome, max(int(cfg["pairs"] * scale), 1), lib["read_len"],
        lib["insert_mean"], lib["insert_sd"], lib["error_rate"],
        np.random.default_rng(seed_for(seed, 1)))
    return Reads(codes=codes, quals=quals, truth=truth,
                 sources={src["name"]: genome})


def fastq_bytes(codes: np.ndarray, quals: np.ndarray, first: int = 0,
                mate: int = 1) -> bytes:
    """Equal-length reads as FASTQ text, built as one array: a fixed-width
    name ``@<index>/<mate>`` a read."""
    R, L = codes.shape
    digits = 10
    idx = np.arange(first, first + R, dtype=np.int64)
    name = np.empty((R, digits), np.uint8)
    for j in range(digits - 1, -1, -1):
        name[:, j] = 48 + idx % 10
        idx //= 10
    row = np.empty((R, 1 + digits + 3 + L + 3 + L + 1), np.uint8)
    c = 0
    for part in (np.full((R, 1), ord("@"), np.uint8), name,
                 np.frombuffer(b"/%d\n" % mate, np.uint8)[None, :].repeat(
                     R, 0),
                 CODE_TO_CHAR[np.minimum(codes, 4)],
                 np.frombuffer(b"\n+\n", np.uint8)[None, :].repeat(R, 0),
                 quals, np.full((R, 1), ord("\n"), np.uint8)):
        row[:, c:c + part.shape[1]] = part
        c += part.shape[1]
    return row.tobytes()


def write_mates(reads: Reads, directory: str, keep=None) -> list[str]:
    """The two mates as gzip FASTQ files (level 1) in ``directory``,
    written in two threads; ``keep`` (a bool mask over the pairs) writes
    only those pairs."""
    n = reads.pairs
    sel = slice(None) if keep is None else np.nonzero(keep)[0]
    paths = [os.path.join(directory, f"reads_{m}.fastq.gz") for m in (1, 2)]

    def write(m):
        lo = 0 if m == 1 else n
        codes = reads.codes[lo:lo + n][sel]
        quals = reads.quals[lo:lo + n][sel]
        with gzip.open(paths[m - 1], "wb", compresslevel=1) as f:
            for a in range(0, codes.shape[0], 1 << 17):
                f.write(fastq_bytes(codes[a:a + (1 << 17)],
                                    quals[a:a + (1 << 17)], a, m))

    with ThreadPoolExecutor(2) as pool:
        list(pool.map(write, (1, 2)))
    return paths
