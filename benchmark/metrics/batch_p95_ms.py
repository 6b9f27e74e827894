"""The 95th percentile of every ``search_batch`` call of the window, ms."""

import numpy as np


def read(run):
    if run.loop != "closed":
        return None
    return 1e3 * float(np.percentile(run.latencies_s, 95))
