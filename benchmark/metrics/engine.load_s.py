"""The program's load of the index onto the device: the time of
``BIGSI(config, device)`` (the engine's ``load_words`` or ``load_cols``),
host clock, s."""


def read(run):
    return run.load_s
