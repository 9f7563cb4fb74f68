"""ng50_kb: NG50 of the first job's contigs.fasta against the summed length
of the truth sequences, in kb (the frozen assessment's
arithmetic)."""

import numpy as np

from portbench.reference import assess, kmers


def read(run):
    if not run.outputs:
        return None
    seqs = kmers.parse_fasta(run.outputs[0]["contigs"])
    lengths = np.array([len(s) for _, s in seqs], np.int64)
    genome = sum(len(s) for s in run.reads.sources.values())
    ng50 = assess._nx(lengths, genome * 0.5)
    return ng50 / 1000.0 if ng50 else None
