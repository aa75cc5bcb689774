"""``launches_per_call``: device operations (kernels, copies, sets) the
profiler recorded per traced call."""


def read(run):
    trace = run.trace
    if trace is None or not trace.device:
        return None
    return len(trace.device) / trace.calls
