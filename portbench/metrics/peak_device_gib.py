"""peak_device_gib: the card's allocated-memory peak over the window
(``torch.cuda.max_memory_allocated``, reset when the window opens), GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
