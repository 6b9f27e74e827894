"""The engine's counts per ``search_batch`` call: span
``search.batch_counts`` (copies, kernels, counts back), ms."""


def read(run):
    return run.per_call_ms("search.batch_counts")
