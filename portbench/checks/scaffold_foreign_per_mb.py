"""scaffold_foreign_per_mb: 31-mers of the N-free runs of scaffolds.fasta
that the truth does not hold, per million judged: wrong bases, chimeric
joins and wrong gap fills each add to it; the worst answer of the
window."""

from portbench import judge


def reading(run):
    return max((judge.foreign_per_mb(run, s) for _, s in
                judge.fasta_answers(run)), default=None)
