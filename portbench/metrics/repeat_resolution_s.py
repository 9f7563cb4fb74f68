"""repeat_resolution_s: seconds a job in gap closing and repeat resolution."""

from portbench.readers import span_seconds_per_job

SPANS = ("stage:gap_closing", "stage:repeat_resolution")


def read(run):
    return span_seconds_per_job(run, SPANS)
