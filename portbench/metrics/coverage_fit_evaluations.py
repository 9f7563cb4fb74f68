"""coverage_fit_evaluations: likelihood evaluations of the coverage
model's fits in the window's one job, over its rungs (the program's
counter fit_evaluations, held on the coverage_em spans).

The program's counters are reset at each job's start, so after the window
they hold its last job alone: the reader returns None unless the window
ran exactly one job, and where the program keeps no such counter (the
benchmark's files also run over earlier checkouts of the program, whose
time trace has no counters)."""


def counters() -> dict:
    """The program's counter totals since its trace was last enabled
    (each job enables it anew), or {} where it keeps none."""
    from spades_for_blackbird_tpu_torch.utils import timetrace
    read = getattr(timetrace, "counters", None)
    return read() if read is not None else {}


def read(run):
    if run.trace is None or run.trace.jobs != 1:
        return None
    return counters().get("fit_evaluations")
