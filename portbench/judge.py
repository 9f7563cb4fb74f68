"""The reference's readings of a run's answers, shared by the checks.

Each reading is taken from what the timed path wrote (the FASTA texts or
the corrected reads), against what the benchmark made itself (the truth
sequences and the error-free reads). The work is cached on the run, so
that several checks judge one answer once."""

from __future__ import annotations

import hashlib

import torch

from .reference import assess, kmers

FOREIGN_K = 31        # the anchor size of the frozen assessment
MIN_COVERAGE_LEN = 1000


def distinct(outputs, key):
    """The answers of a window, each distinct one once."""
    seen, out = set(), []
    for o in outputs:
        h = key(o)
        if h not in seen:
            seen.add(h)
            out.append(o)
    return out


def text_key(o) -> str:
    return hashlib.sha1((o["contigs"] + "\0" + o["scaffolds"]).encode()
                        ).hexdigest()


def cached(run, name, make):
    if name not in run.notes:
        run.notes[name] = make()
    return run.notes[name]


def fasta_answers(run):
    return [(kmers.parse_fasta(o["contigs"]), kmers.parse_fasta(o["scaffolds"]))
            for o in distinct(run.outputs, text_key)]


def missing_share(run, contigs, scaffolds) -> float:
    """1 - the least genome fraction of a truth sequence, over the
    contigs and over the scaffolds with their N's removed."""
    worst = 0.0
    for name in run.reads.sources:
        genome = run.reads.sources[name]
        for seqs in ([s for _, s in contigs],
                     [s.replace("N", "") for _, s in scaffolds]):
            frac = assess.assess(seqs, genome).genome_fraction
            worst = max(worst, 1.0 - frac)
    return worst


def foreign_per_mb(run, records) -> float:
    """Canonical 31-mers of the records' N-free runs that no truth
    sequence holds, per million 31-mers judged."""
    dev = run.device
    truth = cached(run, "truth31", lambda: kmers.truth_set(
        run.reads.sources, FOREIGN_K, dev))
    foreign = total = 0
    for _, seq in records:
        keys = kmers.sequence_keys(seq, FOREIGN_K, dev)
        if keys.numel() == 0:
            continue
        at = torch.searchsorted(truth, keys).clamp_(max=truth.numel() - 1)
        foreign += int((truth[at] != keys).sum())
        total += keys.numel()
    return 1e6 * foreign / total if total else float("inf")


def coverage_gaps(run, contigs) -> list[float]:
    """|coverage in the name / the reference's - 1| of each contig of
    1 kb or more. The reference's is the mean count of the contig's
    canonical (K+1)-mers, K the last rung's, over the error-free reads,
    plus one: the multi-K assembly counts the previous rung's contigs as
    one more read over each of their (K+1)-mers, and the reference takes
    them to cover the contig."""
    k = run.cell.config["coverage_k"]
    table = cached(run, f"count{k}", lambda: kmers.count_table(
        run.reads.truth, k, run.device))
    gaps = []
    for name, seq in contigs:
        cov = kmers.name_coverage(name)
        if len(seq) < MIN_COVERAGE_LEN or cov is None:
            continue
        keys = kmers.sequence_keys(seq, k, run.device)
        if keys.numel() == 0:
            continue
        ref = float(kmers.lookup(table, keys).double().mean()) + 1.0
        gaps.append(abs(cov / ref - 1.0) if ref > 0 else float("inf"))
    return gaps


def wrong_after_share(run, corrected) -> float:
    """Bases wrong after correction (left or made) over bases wrong
    before, against the error-free reads."""
    dev = corrected.device
    truth = cached(run, "truth_reads",
                   lambda: torch.from_numpy(run.reads.truth).to(dev))
    raw = cached(run, "raw_reads",
                 lambda: torch.from_numpy(run.reads.codes).to(dev))
    before = int((raw != truth).sum())
    after = int((corrected != truth).sum())
    return after / before if before else float("inf")
