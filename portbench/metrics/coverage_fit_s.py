"""coverage_fit_s: seconds a job in the coverage model's fit (SciPy on the
host)."""

from portbench.readers import span_seconds_per_job

SPANS = ("coverage_model_fit",)


def read(run):
    return span_seconds_per_job(run, SPANS)
