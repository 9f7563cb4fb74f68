"""Read-set simulation for scale runs and quality benchmarks.

The reference validates on real datasets (E. coli MC4100 28M reads,
the reference's README.md:139-148); those are not shipped with the repository,
so we generate a ground-truth genome + Illumina-like paired reads
in-repo and measure assembly quality against the known truth
(utils/assess.py). Vectorized numpy throughout — simulating 1M+ read
pairs must not be the bottleneck of the run it feeds.
"""

from __future__ import annotations

import gzip

import numpy as np

_ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.zeros(256, np.uint8)
for a, b in zip(b"ACGTN", b"TGCAN"):
    _COMP[a] = b


def random_genome(length: int, seed: int = 0,
                  repeats: list[tuple[int, int]] | None = None,
                  gc: float = 0.5) -> str:
    """Random genome with optional planted exact repeats.

    ``repeats``: list of (repeat_len, n_copies); each repeat sequence is
    drawn once and overwritten at random non-overlapping positions —
    the layouts that make repeat resolution non-trivial.
    """
    rng = np.random.default_rng(seed)
    p_gc = gc / 2.0
    p_at = (1.0 - gc) / 2.0
    arr = rng.choice(_ALPHA, size=length, p=[p_at, p_gc, p_gc, p_at])
    if repeats:
        taken: list[tuple[int, int]] = []
        for rep_len, copies in repeats:
            unit = rng.choice(_ALPHA, size=rep_len)
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


def revcomp_bytes(seq: np.ndarray) -> np.ndarray:
    return _COMP[seq[::-1]]


def simulate_paired_reads(genome: str, n_pairs: int, read_len: int = 100,
                          insert_mean: float = 300.0,
                          insert_sd: float = 25.0,
                          error_rate: float = 0.002,
                          seed: int = 1):
    """Illumina-like FR paired reads with per-base quality strings.

    Returns (reads1, quals1, reads2, quals2) as lists of str. Errors are
    uniform substitutions; erroneous bases get low phred (+ a background
    of low-quality correct bases) so quality-aware correction has signal
    to work with, mirroring real Illumina profiles.
    """
    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome.encode("ascii"), dtype=np.uint8)
    L = len(g)
    ins = np.clip(rng.normal(insert_mean, insert_sd, n_pairs).astype(int),
                  read_len, None)
    start = rng.integers(0, np.maximum(L - ins, 1), n_pairs)
    fwd = rng.random(n_pairs) < 0.5

    # fragment matrix (n_pairs, max_ins) gather is too big; gather the
    # two read windows directly
    offs = np.arange(read_len)
    r1_pos = start[:, None] + offs[None, :]
    r2_pos = start[:, None] + (ins - read_len)[:, None] + offs[None, :]
    r1 = g[np.minimum(r1_pos, L - 1)]
    r2 = g[np.minimum(r2_pos, L - 1)]
    # r2 faces upstream (FR): reverse complement
    r2 = _COMP[r2[:, ::-1]]
    # fragments on the reverse strand: swap mates and rc both
    r1f = np.where(fwd[:, None], r1, _COMP[r2[:, ::-1]])
    r2f = np.where(fwd[:, None], r2, _COMP[r1[:, ::-1]])
    r1, r2 = r1f, r2f

    def add_errors(reads):
        err = rng.random(reads.shape) < error_rate
        # substitute with a DIFFERENT base: shift by 1..3 in code space
        code = np.searchsorted(_ALPHA, reads)  # ACGT sorted already
        shift = rng.integers(1, 4, reads.shape)
        reads = np.where(err, _ALPHA[(code + shift) % 4], reads)
        qual = np.full(reads.shape, 38, np.uint8)
        lowq_bg = rng.random(reads.shape) < 0.01
        qual = np.where(lowq_bg, 12, qual)
        qual = np.where(err & (rng.random(reads.shape) < 0.7), 8, qual)
        return reads, qual + 33

    r1, q1 = add_errors(r1)
    r2, q2 = add_errors(r2)
    to_str = lambda m: [row.tobytes().decode("ascii") for row in m]
    return to_str(r1), to_str(q1), to_str(r2), to_str(q2)


def write_fastq(path: str, reads: list[str], quals: list[str],
                prefix: str = "read") -> None:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "wt") as f:
        for i, (r, q) in enumerate(zip(reads, quals)):
            f.write(f"@{prefix}_{i}\n{r}\n+\n{q}\n")
