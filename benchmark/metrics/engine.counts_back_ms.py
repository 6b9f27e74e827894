"""The engine's counts back per ``search_batch`` call: span
``engine.counts_back`` (the copy of the counts to the host, with any wait
for the kernels ahead of it), ms."""


def read(run):
    return run.per_call_ms("engine.counts_back")
