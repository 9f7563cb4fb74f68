"""simplify_s: seconds a job simplifying graphs (tips, bulges, erroneous
connections)."""

from portbench.readers import span_seconds_per_job

SPANS = ("simplify",)


def read(run):
    return span_seconds_per_job(run, SPANS)
