"""missing_share: 1 - the least genome fraction of a graded truth
sequence, over contigs.fasta and over scaffolds.fasta with their N's
removed (the frozen assessment's), the worst answer of the window."""

from portbench import judge


def reading(run):
    answers = judge.fasta_answers(run)
    return max((judge.missing_share(run, c, s) for c, s in answers),
               default=None)
