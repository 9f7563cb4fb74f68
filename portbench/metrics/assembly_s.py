"""assembly_s: window seconds over the jobs completed, each job the command
line from FASTQ files to contigs and scaffolds."""


def read(run):
    return run.window_s / run.jobs if run.jobs else None
