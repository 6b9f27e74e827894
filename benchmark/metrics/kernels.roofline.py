"""The window's kernels against the memory roofline: the least time the
window's work could take at the card's memory bandwidth (the bytes that
``work/<work>.py`` counts for each call: distinct index bytes, queries,
counts, strings) over the summed device time of every kernel in the
traced window, %.  Nothing when the trace holds no kernel time."""

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's memory bandwidth (NVIDIA's data sheet)


def read(run):
    tl = run.timeline
    if tl is None or not tl.kernel_s or not run.work_bytes:
        return None
    return 100.0 * run.work_bytes / HBM_BYTES_PER_S / tl.kernel_s
