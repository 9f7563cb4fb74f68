"""hammer_subcluster_s: seconds a job in the corrector's Bayesian
subclustering."""

from portbench.readers import span_seconds_per_job

SPANS = ("hammer_subcluster",)


def read(run):
    return span_seconds_per_job(run, SPANS)
