"""setup_s: seconds from the process's start to the window's: imports, the
CUDA context, simulation, writing the inputs, the warm-up job and, in a
checkout's first run, the kernels' build."""


def read(run):
    return run.setup_s
