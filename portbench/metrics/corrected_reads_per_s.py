"""corrected_reads_per_s: every read of every completed job over the
window's seconds."""


def read(run):
    if not run.jobs or run.window_s <= 0:
        return None
    return run.jobs * run.reads.codes.shape[0] / run.window_s
