"""kmer_extract_roofline.program.assembly: percent of the k-mer extraction's
device time in the window's last job that its published-peak bound
accounts for, from the launch records the program keeps itself (the
assembly cells)."""

from portbench.launch_records import kmer_extract_roofline


def read(run):
    return kmer_extract_roofline(run) if run.kind == "assembly" else None
