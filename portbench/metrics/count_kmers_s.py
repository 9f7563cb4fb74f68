"""count_kmers_s: seconds a job counting (k+1)-mers of the reads and of the
previous rung's contigs."""

from portbench.readers import span_seconds_per_job

SPANS = ("count_kmers", "count_extra_contigs")


def read(run):
    return span_seconds_per_job(run, SPANS)
