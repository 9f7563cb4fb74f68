"""hammer_count_s: seconds a job in the corrector's k-mer counts."""

from portbench.readers import span_seconds_per_job

SPANS = ("hammer_count",)


def read(run):
    return span_seconds_per_job(run, SPANS)
