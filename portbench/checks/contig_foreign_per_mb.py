"""contig_foreign_per_mb: 31-mers of contigs.fasta that the truth does not
hold, per million judged: wrong bases and chimeric joins each add to it
(the contigs are exact copies of the truth); the worst answer of the
window."""

from portbench import judge


def reading(run):
    return max((judge.foreign_per_mb(run, c) for c, _ in
                judge.fasta_answers(run)), default=None)
