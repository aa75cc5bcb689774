"""``loop_iterations``: driver-loop iterations per call, summed over the
call's loops (the multiscale levels): each loop runs until its slowest lane
stops, so each adds its slowest lane's count.  Mean over the traced calls."""


def read(run):
    trace = run.trace
    if trace is None or not trace.levels or not all(trace.levels):
        return None
    total = sum(max(lv.iterations) for call in trace.levels for lv in call)
    return total / len(trace.levels)
