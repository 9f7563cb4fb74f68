"""fastq_parse_s: seconds a job parsing the FASTQ files (the span
read_parse inside read_conversion: the native gzip parse of each
library, before the concatenation and the upload)."""

from portbench.readers import span_seconds_per_job

SPANS = ("read_parse",)


def read(run):
    return span_seconds_per_job(run, SPANS)
