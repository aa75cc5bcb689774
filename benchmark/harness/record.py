"""What a metric reader reads: one run's record.

``RunRecord`` holds the host clock's readings of the run (set-up, each
call's start and end in the measured window) and, in a ``--trace 1`` run,
the :class:`TraceSlice` of the profiled calls.  Readers take what they need
and return ``None`` where the record holds nothing for them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Level:
    """One driver loop (one level of a multiscale call) of a profiled call."""

    source_count: list  # valid source points per lane
    target_count: list  # valid target points per lane
    iterations: list  # iterations per lane
    dim: int
    dtype_bytes: int


@dataclasses.dataclass
class TraceSlice:
    """The profiled calls of a ``--trace 1`` run.

    ``device`` and ``host`` are ``(name, start_ns, end_ns)`` of every device
    operation (kernels, copies, sets) and every host event the profiler
    recorded; ``levels[c]`` are call ``c``'s driver loops, in order.
    """

    calls: int
    wall_s: float
    device: list
    host: list
    levels: list
    nn_per_lane: dict  # {"init": k, "iteration": k}: NN evaluations a lane needs

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, sorted."""
        merged = []
        for lo, hi in sorted((s, e) for _, s, e in self.device):
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return merged

    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals()) / 1e9


@dataclasses.dataclass
class RunRecord:
    setup_s: float
    lanes: int
    call_starts: list  # host clock, seconds, of each call of the window
    call_ends: list
    trace: TraceSlice | None = None

    @property
    def calls(self) -> int:
        return len(self.call_ends)

    @property
    def window_s(self) -> float:
        return self.call_ends[-1] - self.call_starts[0]
