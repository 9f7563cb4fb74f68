"""error_correction_s: seconds a job in the error_correction stage
(BayesHammer)."""

from portbench.readers import span_seconds_per_job

SPANS = ("stage:error_correction",)


def read(run):
    return span_seconds_per_job(run, SPANS)
