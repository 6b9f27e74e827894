"""Set-up: from the process's start to the window's first timed call or
request (imports, builds found or made, the index's synthesis, the
program's load, the warm-up)."""


def read(run):
    return run.setup_s
