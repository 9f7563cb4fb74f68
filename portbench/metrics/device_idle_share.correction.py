"""device_idle_share.correction: percent of the window in which no kernel,
copy or set ran on the card (the correction cells)."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run) if run.kind == "correction" else None
