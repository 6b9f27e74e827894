"""The facade's prep of a seq-arm batch per ``search_batch`` call: span
``search.seq_prep`` (join, ASCII encode, ACGT gate, padding), ms."""


def read(run):
    return run.per_call_ms("search.seq_prep")
