"""checkpoint_s: seconds a job writing saves: the pre-simplify save of
every rung and the stage saves."""

from portbench.readers import span_seconds_per_job

SPANS = ("phase_checkpoint", "checkpoint_save")


def read(run):
    return span_seconds_per_job(run, SPANS)
