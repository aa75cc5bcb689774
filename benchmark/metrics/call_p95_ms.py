"""``call_p95_ms``: the 95th percentile of every call's time in the window
(start to results on the host), linear between order statistics.  Host
clock."""

import numpy as np


def read(run):
    if not run.calls:
        return None
    times = np.asarray(run.call_ends) - np.asarray(run.call_starts)
    return float(np.percentile(times, 95)) * 1e3
