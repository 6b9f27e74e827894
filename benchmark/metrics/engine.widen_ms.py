"""The engine's widening of the counts per ``search_batch`` call: span
``engine.widen`` (int32 to int64 on the host), ms."""


def read(run):
    return run.per_call_ms("engine.widen")
