"""The share of the traced window in which no kernel or copy ran on the
device (profiler timeline), %."""


def read(run):
    tl = run.timeline
    if tl is None or not tl.window_s:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
