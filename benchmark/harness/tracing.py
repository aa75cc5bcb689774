"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over a few calls.

The busy share is ``chip_smoke.py::_trace``'s: the union of the device
operations' intervals over the slice's wall time.  The events are read from
the profiler's raw Kineto records, which is much cheaper than building its
``FunctionEvent`` tree over tens of thousands of launches.  The Chrome trace
of the slice is written, gzipped, to ``build/benchmark/trace/<cell>.json.gz``
in the checkout (one file per cell, overwritten by the next traced run).
"""

from __future__ import annotations

import bisect
import collections
import os
import time

import torch

from .record import TraceSlice

TOP = 10


def _events(prof):
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(span)
        else:
            host.append(span)
    return device, host


def profile_calls(call, calls: int, nn_per_lane: dict, trace_path: str | None):
    """Run ``call(i, levels)`` for ``i < calls`` under the profiler; each call
    appends its driver loops to ``levels`` and returns when its results are
    on the host side of a synchronise."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    levels = []
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            levels.append([])
            call(i, levels[-1])
        wall = time.perf_counter() - t0
    if trace_path is not None:
        os.makedirs(os.path.dirname(trace_path), exist_ok=True)
        prof.export_chrome_trace(trace_path)
    device, host = _events(prof)
    return TraceSlice(calls=calls, wall_s=wall, device=device, host=host, levels=levels,
                      nn_per_lane=nn_per_lane)


def breakdown(trace: TraceSlice) -> dict:
    """The device operations that took most time, and the device's idle time
    by what the host was doing (the innermost host event at the middle of
    each gap between device operations), each list at most ``TOP`` long."""
    ops = collections.Counter()
    for name, s, e in trace.device:
        ops[name[:120]] += (e - s) / 1e9
    host = sorted(trace.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps = collections.Counter()
    busy = trace.busy_intervals()
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = (end + start) / 2
        name = "host: between recorded events"
        last = bisect.bisect_right(starts, mid) - 1
        for k in range(last, max(-1, last - 64), -1):
            if host[k][2] >= mid:
                name = host[k][0][:120]
                break
        gaps[name] += (start - end) / 1e9
    return {"device_ops": [[n, s] for n, s in ops.most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(TOP)]}
