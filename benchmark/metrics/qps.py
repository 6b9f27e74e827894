"""A closed loop's queries answered in the window over the window's
seconds: one client, each ``search_batch`` call after the last returns."""


def read(run):
    if run.loop != "closed":
        return None
    return run.answered / run.window_s
