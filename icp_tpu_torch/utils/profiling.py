"""Profiling hooks and roofline accounting.

Port of :mod:`icp_tpu.utils.profiling`: :func:`trace` wraps
``torch.profiler`` (CPU and CUDA activities) and writes a Chrome trace,
:func:`time_fn` wall-clocks a function and waits for the card before each
clock read, and :func:`nn_roofline` is the first-principles count of the
1-NN correspondence.  :func:`nvtx_range` names a span of host code in the
card's timeline (``driver.converge`` and ``slam.OnlineSlam`` mark theirs);
it does nothing for work on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch


def nvtx_range(name: str, device):
    """An NVTX range named ``name`` around a ``with`` block when ``device``
    is a CUDA device, else a context that does nothing."""
    if torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.nvtx.range(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("/tmp/torch-trace"):`` profiles the block (host ops and,
    with a card, its kernels) and writes ``log_dir/trace.json``, a Chrome
    trace (Perfetto, ``chrome://tracing``).  Yields the profiler, whose
    ``events()`` / ``key_averages()`` are readable after the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclasses.dataclass
class Timing:
    seconds: float
    runs: int

    @property
    def per_run(self) -> float:
        return self.seconds / max(self.runs, 1)


def _wait():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn, *args, runs: int = 10, warmup: int = 1) -> Timing:
    """Wall-clock ``runs`` calls of ``fn(*args)`` after ``warmup`` calls,
    waiting for the card's queued work before each clock read."""
    for _ in range(warmup):
        fn(*args)
    _wait()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn(*args)
    _wait()
    return Timing(time.perf_counter() - t0, runs)


def nn_roofline(n: int, m: int, dim: int, batch: int = 1, dtype_bytes: int = 4) -> dict:
    """FLOPs / bytes / arithmetic intensity of the fused NN correspondence.

    Per (query, target) pair: ``dim`` subtracts + ``dim`` multiplies +
    ``dim-1`` adds, plus the running min/argmin compare-select (~2 ops).
    Fused (no (N, M) materialization), bytes = inputs + outputs only.
    """
    flops = batch * n * m * (3 * dim + 1)
    bytes_accessed = batch * dtype_bytes * (n * dim + m * dim + 2 * n)
    return {
        "flops": flops,
        "bytes": bytes_accessed,
        "intensity_flops_per_byte": flops / bytes_accessed,
    }
