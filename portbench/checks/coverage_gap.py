"""coverage_gap: the widest gap, over the contigs of 1 kb or more, between
the coverage written into a contig's name and the reference's recount of
it from the error-free reads; the worst answer of the window."""

from portbench import judge


def reading(run):
    gaps = [max(judge.coverage_gaps(run, c), default=float("inf"))
            for c, _ in judge.fasta_answers(run)]
    return max(gaps, default=None)
