"""kmer_extract_roofline.assembly: percent of the hand kernel's device time
that its published-peak bound accounts for, over every launch in the
window (the assembly cells)."""

from portbench.readers import kmer_extract_roofline


def read(run):
    return kmer_extract_roofline(run) if run.kind == "assembly" else None
