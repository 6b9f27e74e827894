"""The seq arm's bucketing per ``search_batch`` call: span
``engine.seq_geometry`` (the guards and the padding to the length and
batch buckets), ms."""


def read(run):
    return run.per_call_ms("engine.seq_geometry")
