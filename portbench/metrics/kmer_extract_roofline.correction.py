"""kmer_extract_roofline.correction: percent of the hand kernel's device
time that its published-peak bound accounts for, over every launch in
the window (the correction cells)."""

from portbench.readers import kmer_extract_roofline


def read(run):
    return kmer_extract_roofline(run) if run.kind == "correction" else None
