"""coverage_wait_s: seconds a job that the rungs wait for the coverage
model's fit (the span coverage_wait). The fit runs on a host worker
thread; each rung waits for it where its answer is first read, inside the
pre-simplify save on the command line. The span counts fit_joined, and
fit_ready where the fit had ended before the rung came to read it."""

from portbench.readers import span_seconds_per_job

SPANS = ("coverage_wait",)


def read(run):
    return span_seconds_per_job(run, SPANS)
