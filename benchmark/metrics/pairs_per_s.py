"""``pairs_per_s``: registrations completed in the window over the window's
time, from the first call's start to the last call's end.  Host clock."""


def read(run):
    if not run.calls:
        return None
    return run.calls * run.lanes / run.window_s
