"""The device's peak allocation over the program's load, warm-up and
window (``torch.cuda.max_memory_allocated``), GB."""


def read(run):
    return run.memory_peak_bytes / 1e9 if run.memory_peak_bytes else None
