"""checkpoint_compress_s: seconds a job compressing and writing the
pre-simplify saves (the span checkpoint_compress inside phase_checkpoint:
np.savez_compressed and the rename, after the graph's copy to the
host)."""

from portbench.readers import span_seconds_per_job

SPANS = ("checkpoint_compress",)


def read(run):
    return span_seconds_per_job(run, SPANS)
