"""read_conversion_s: seconds a job in the read_conversion stage (FASTQ
parse and upload)."""

from portbench.readers import span_seconds_per_job

SPANS = ("stage:read_conversion",)


def read(run):
    return span_seconds_per_job(run, SPANS)
