"""The seq arm's launches whose counts went unused, as a share of all its
launches, %: counters ``engine.seq_launches`` (kernels H and E, once a
budget tried), ``engine.seq_calls`` and ``engine.seq_refused`` (calls
that returned None); a served call uses one launch."""


def read(run):
    launches = run.counts.get("engine.seq_launches", 0)
    if not launches:
        return None
    served = run.counts.get("engine.seq_calls", 0) - run.counts.get("engine.seq_refused", 0)
    return 100.0 * (launches - served) / launches
