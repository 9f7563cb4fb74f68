"""graph_build_s: seconds a job building graphs: vertex table, early tips,
condensation."""

from portbench.readers import span_seconds_per_job

SPANS = ("vertex_table", "early_tips", "condense")


def read(run):
    return span_seconds_per_job(run, SPANS)
