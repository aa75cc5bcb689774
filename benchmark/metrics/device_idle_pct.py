"""``device_idle_pct``: 100 - the device's busy share of the traced calls'
wall time, the busy time being the union of the device operations'
intervals (``chip_smoke.py::_trace``'s measure)."""


def read(run):
    trace = run.trace
    if trace is None or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.wall_s)
