"""The facade's result building per ``search_batch`` call: span
``search.batch_results`` less the scoring spans inside it
(``search.presence``, ``search.score``), ms."""


def read(run):
    return run.per_call_ms("search.batch_results", less=("search.presence", "search.score"))
