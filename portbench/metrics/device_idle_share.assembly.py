"""device_idle_share.assembly: percent of the window in which no kernel,
copy or set ran on the card (the assembly cells)."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run) if run.kind == "assembly" else None
