"""The share of the engine's hits calls whose hits came back as hits,
not as the dense counts, %: counters ``engine.hits_calls`` (batches whose
counts were thresholded on the card) and ``engine.hits_overflow`` (those
whose hits outgrew the record's room and took the dense copy)."""


def read(run):
    calls = run.counts.get("engine.hits_calls", 0)
    if not calls:
        return None
    return 100.0 * (calls - run.counts.get("engine.hits_overflow", 0)) / calls
