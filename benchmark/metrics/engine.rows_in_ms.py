"""The engine's row ids in per ``search_batch`` call: span
``engine.rows_in`` (the id check, the int32 and bool conversions, the
copies to the card), ms."""


def read(run):
    return run.per_call_ms("engine.rows_in")
