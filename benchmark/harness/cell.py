"""One run of one cell: set up, warm up, measure, check, report.

The order of a run:

1. set-up: read the configuration and the traffic, check the pinned data,
   make the traffic's batches on the device from ``--seed`` (by the
   generator its ``kind`` names), build the program's method, and warm up
   with one call (its shapes are the only ones the window uses);
   ``setup_s`` runs from the process's start to here;
2. the window, as the generator drives it; with ``--trace 1`` a few of its
   calls run under the profiler;
3. after the window: the peak device memory, the check that no JAX module
   was loaded, then the program's answers are kept (all of them, or a
   sample drawn from the seed) and its state freed, and the plain
   reference computes the lanes of those answers again from their inputs,
   on the same device, in float64;
4. the report: the cell's metrics by their readers, the compared numbers
   with their limits on standard error, and one JSON line on standard
   output.  A metric of the cell that reads nothing ends the run with no
   result (exit code 5): a metric that falls silent is a changed yardstick.
   Only on the CPU, where the profiler sees no device, may a metric read
   from the device trace be missing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

from . import compare, data, reference, roofline, spec, tracing
from .record import RunRecord
from .system import System, device_name, levels_of

FORBIDDEN = ("jax", "jaxlib", "flax", "icp_tpu")
SAMPLE_SALT = 0x5EED


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi not read ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def _strided(pairs: list, stride: int) -> list:
    return [dict(p, source=p["source"][::stride], target=p["target"][::stride])
            for p in pairs]


def _sample(seed: int, answers: int, size) -> torch.Tensor:
    """The indices of the compared answers: all, or ``size`` drawn from the seed."""
    if size == "all" or int(size) >= answers:
        return torch.arange(answers)
    gen = torch.Generator().manual_seed((int(seed) ^ SAMPLE_SALT) % 2**63)
    return torch.sort(torch.randperm(answers, generator=gen)[:int(size)]).values


def run(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        root: str = spec.ROOT, device: str = "cuda", check_chip: bool = True,
        overrides: dict | None = None, patch=None, out=None, err=None,
        extras: dict | None = None) -> int:
    """One run; prints the result line and returns the exit code.

    For tests and the readings of ``benchmark/readings.py`` only:
    ``overrides`` replaces traffic keys and may give ``point_stride``, which
    keeps every k-th point of each cloud; ``patch`` is called with the
    :class:`System` before the warm-up and may replace its method or its
    ``call``; ``extras``, a dict, receives the result and every compared
    answer's gaps.
    """
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    cell = spec.load_cell(workload, root)
    if check_chip:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{workload} needs {cell.chips} CUDA card(s); "
                  f"torch.cuda.is_available() {torch.cuda.is_available()}, "
                  f"device_count {count}", file=err)
            return 3
    overrides = dict(overrides or {})
    stride = int(overrides.pop("point_stride", 1))
    mix = dict(cell.traffic, **overrides)
    generator = spec.module("generators", mix["kind"], root)
    settings = cell.config["system"]
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    # 1. Set-up; each step's end is kept for the log.
    marks = [("start", t_start), ("imports", time.perf_counter())]
    data.check_pinned(root, cell.config["data"]["sha256"])
    pairs = _strided(data.load_pairs(root, cell.config["data"]["pairs"]), stride)
    marks.append(("data", time.perf_counter()))
    capacity = -(-settings["capacity"] // stride)
    dtype = getattr(torch, settings["dtype"])
    batches = generator.make(pairs, capacity, mix, seed, dtype, device)
    sync()
    marks.append(("batches", time.perf_counter()))
    system = System(settings, root)
    marks.append(("program", time.perf_counter()))
    if torch.backends.cuda.matmul.allow_tf32 != settings["tf32"]:
        raise RuntimeError(f"the program runs with TF32 {torch.backends.cuda.matmul.allow_tf32}; "
                           f"the configuration states {settings['tf32']}")
    if patch is not None:
        patch(system)
    inputs = [system.inputs(b) for b in batches]
    system.call(inputs[0])
    sync()
    marks.append(("warm-up call", time.perf_counter()))
    setup_s = marks[-1][1] - t_start

    # 2. The window.
    lanes, nb = int(mix["lanes"]), len(inputs)
    answers, starts, ends = [], [], []

    def one(i, levels=None):
        s = time.perf_counter()
        if levels is None:
            got = system.call(inputs[i % nb])
        else:
            with system.recording_levels(levels):
                got = system.call(inputs[i % nb])
        sync()
        if len(ends) != i:
            raise RuntimeError(f"the window made call {i} after {len(ends)} calls")
        starts.append(s)
        ends.append(time.perf_counter())
        answers.append(got)
        return starts[-1], ends[-1]

    traced_slice = []

    def traced(i, count):
        path = os.path.join(root, "build", "benchmark", "trace", f"{workload}.json.gz")
        traced_slice.append(tracing.profile_calls(lambda j, lv: one(i + j, lv), count,
                                                  settings["nn_per_lane"],
                                                  path if cuda else None))
        return starts[i], ends[-1]

    generator.window(one, nb, mix, seconds, traced if trace else None)
    sliced = traced_slice[0] if traced_slice else None

    # 3. After the window.
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded in the run's process: {loaded}", file=err)
        return 4
    nonfinite = sum(int((~(torch.isfinite(r).flatten(1).all(1) & torch.isfinite(t).all(1)))
                        .sum()) for r, t, _ in answers)
    picks = _sample(seed, len(answers) * lanes, mix["sample"])
    program = tuple(torch.cat([a[k] for a in answers])[picks.to(answers[0][k].device)].cpu()
                    for k in range(3))
    keys, at = torch.unique((picks // lanes % nb) * lanes + picks % lanes, return_inverse=True)
    ref_inputs = [torch.cat([getattr(b, f) for b in batches])[keys.to(device)]
                  for f in ("source", "source_count", "target", "target_count", "rotation",
                            "translation")]
    del answers, inputs, batches, system
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference.register_blocks(settings, "float64", ref_inputs, device, root)
    ref_s = time.perf_counter() - t_ref
    ref = {k: (tuple(x[at] for x in v) if isinstance(v, tuple) else v[at])
           for k, v in ref.items()}
    correct_spec = cell.config["correct"]
    per_answer = compare.gaps(*program, ref)
    checks = compare.judge(per_answer, correct_spec)
    read = compare.numbers(per_answer, correct_spec["far_m"])

    # 4. The report.
    record = RunRecord(setup_s=setup_s, lanes=lanes, call_starts=starts, call_ends=ends)
    if sliced is not None:
        sliced.levels = [levels_of(lv) for lv in sliced.levels]
        record.trace = sliced
    metrics, silent = {}, []
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif cuda or m["source"] != "device_trace":
            silent.append(m["name"])
    if silent:
        print(f"{workload}: the cell's metrics {silent} read nothing in this run "
              f"(recorded driver loops: {[len(c) for c in sliced.levels] if sliced else None})",
              file=err)
        return 5
    correct = (nonfinite == 0 and len(picks) > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if cuda else "cpu", "kind": device_name(),
           "count": cell.chips if cuda else 0, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": record.calls * lanes,
              "failed": nonfinite, "metrics": metrics, "device": dev}
    if sliced is not None:
        dev["busy_s"] = sliced.busy_s()
        dev["window_s"] = sliced.wall_s
        result["breakdown"] = tracing.breakdown(sliced)
    result["checks"] = checks
    if extras is not None:
        extras.update(result=result, gaps=per_answer, numbers=read, reference_s=ref_s,
                      inputs=ref_inputs, at=at, program=program, reference=ref,
                      settings=settings)
    print(f"{workload} seed {seed}: {record.calls} calls of {lanes} lanes in "
          f"{record.window_s:.3f} s; set-up {setup_s:.3f} s ("
          + ", ".join(f"{name} {t - before:.3f}" for (_, before), (name, t) in
                      zip(marks, marks[1:])) + f"); reference over "
          f"{len(keys)} lanes ({len(picks)} answers) {ref_s:.3f} s; non-finite answers "
          f"{nonfinite}; readings {read}",
          file=err)
    if cuda:
        print(f"peaks: {roofline.PEAK_F32_FLOPS:.4g} flop/s float32, "
              f"{roofline.PEAK_HBM_BYTES:.4g} B/s HBM; card: {power_limit()}", file=err)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
