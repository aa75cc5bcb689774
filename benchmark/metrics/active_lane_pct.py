"""``active_lane_pct``: the driver's useful work over what it launched: the
lanes' iterations summed, over lanes times loop iterations, in percent, over
every loop of the traced calls.  A frozen lane is still computed and
discarded, so 100 - this is the share of lane-iterations wasted."""


def read(run):
    trace = run.trace
    if trace is None or not trace.levels or not all(trace.levels):
        return None
    done = sum(sum(lv.iterations) for call in trace.levels for lv in call)
    launched = sum(len(lv.iterations) * max(lv.iterations) for call in trace.levels for lv in call)
    return 100.0 * done / launched if launched else None
