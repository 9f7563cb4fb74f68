"""seg_sum_roofline.program.assembly: percent of the ordered sum's device
time in the window's last job that its published-peak bound accounts for,
from the launch records the program keeps itself (the assembly cells)."""

from portbench.launch_records import seg_sum_roofline


def read(run):
    return seg_sum_roofline(run) if run.kind == "assembly" else None
