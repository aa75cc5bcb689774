#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, in phases.

    python3 chip_smoke.py

1. Device and TF32: a CUDA card is required (there is no CPU fallback);
   prints the card's name and power limit; TF32 must be off.
2. Build: compiles ``icp_tpu_torch/csrc/nn.cu`` with nvcc (sm_90a) and
   prints the seconds it took and ptxas' registers and spills per kernel
   instance.
3. Kernel vs plain version on the card: the 1-NN kernel, with the matched
   coordinates (K1) and without (K2), against its plain PyTorch version on
   the same inputs, at the main path's two shapes and at shapes that reach
   its other code paths (targets in several shared-memory stages, N not a
   multiple of the queries per warp, lanes sharing a block, D = 3, float64).
   Indices and coordinates must be equal and ``sq`` bit-equal.  At the main
   path's two shapes and two staged ones, times both with CUDA events, per
   call from the host and per launch from a CUDA graph (the device's time),
   beside their bound (the larger of the valid pairs' flops at the float32
   peak and the bytes at the memory rate); at the main path's shapes also
   the plain version and ``torch.cdist(...).min(-1)``, unmasked: a
   yardstick the port never calls, not the same function.
4. Main path: 2D trimmed ICP on scan1, B = 1024 lanes at capacity 1024 in
   float32 under the seeded perturbed guesses, through ``converge_multiscale``
   (decimation 4 with at most 30 iterations, then full resolution: 50
   iterations, 0.1 deg, 0.01 m).  Counts the kernel's launches in that run.
   Then one run under torch.profiler (the device's busy share, the kernels
   by device time) and the time of each step of one iterate.
5. Pose agreement: 32 of those lanes again on the CPU (``device="cpu"``:
   the entry points default to the card) in float64 with the plain version;
   the translation deviation must stay <= 2e-3 m.
6. The 3D path: ``trimmed`` (max_distance 1.0) and ``vanilla`` 3D on the
   10,720-point queen-scale PLY pair, B = 1, float32, through ``read_ply``,
   ``from_points``, ``from_method`` and ``converge`` (100 iterations, 1e-4
   rad, 1e-4 m).  Counts K1's launches in each run; trimmed must bring the
   mean NN distance below 0.05 and below 0.2x its start, vanilla must lower
   it.  Prints iterations, the median of 5 timed calls, the traced device
   busy share, and the ms per call of each step of one iterate (with the
   quaternion fit's kernel count).  Both methods again on the CPU in float64
   (SVD): translation within 2e-3 m, rotation columns unit to 1e-5.
7. The 2D method matrix (``bench.py::run_matrix``): ``vanilla``,
   single-scale ``trimmed`` and ``feature_aware`` on scans 1-3, B = 256,
   float32, capacity 1024 (scan2, with 1,090 points, at 1,096), the bench's
   seeded guesses and driver config, through ``make_converge_fn``: pairs/s
   (median of 3 after a warm-up), mean iterations and cost, kernel launches,
   peak device memory.  8 lanes of scan1 per method against the CPU float64
   run, gate 2e-3 m.

8. The net-new families (``bench.py::run_gicp``/``run_ndt``, the
   scan-to-map rows): (a) ``point_to_plane``, ``robust``, ``symmetric``
   (phase 7's guesses), ``gicp`` and ``ndt`` p2d / d2d (cell 0.5, 1,024
   slots; the bench's hard guesses, +-0.15 rad, +-0.6 m) on scans 1-3 at
   B = 256 as in phase 7, NDT also with its lanes within 5 cm of the
   trimmed pose; (b) ``converge_ndt_multiscale`` (8x -> 2x -> 1x cells) on
   scan1; each family's init and iterate on scan1 (ms and kernels per
   call) and a trace of the slowest iterate; (c) 3D gicp at queen scale:
   precompute ms, ms per iterate over 50 chained iterates (best of 3),
   kernels per iterate and a trace; (d) 3D NDT, a 4,096-point scan against
   a 65,536-point sphere map: build ms, no overflow, dense and sorted
   lookups equal, ms per iterate of each; (e) pose gates: 8 lanes of scan1
   per 2D family and the torus pair for 3D point_to_plane and gicp, CUDA
   float32 against CPU float64 (a lane over the gate is rerun on the CPU in
   float32, from its guess and with the guess angle 1 ulp either side, and
   passes only if one of those misses too: a float32 property).

Phase 3 also runs K1 and K2 on the queen-scale pair itself,
(1, 10720, 10720, 3) float32, timed beside its bound, the plain version and
the library yardstick, and on phase 7's inputs (scans 1-3 at B = 256 under
its guesses: (256, 1024, 1024, 2) and scan2's (256, 1096, 1096, 2), whose
last query block is ragged) and scan1 under phase 8's hard guesses, exact.
Each phase prints its seconds; the kernels line lists every case held exact
and the launches of every path.

Any failure raises (non-zero exit).  The line before the last is a JSON
object of the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import resource
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 1024
CAPACITY = 1024
POSE_LANES = 32
POSE_AGREEMENT_TOL_M = 2e-3
MATRIX_BATCH = 256
MATRIX_POSE_LANES = 8
QUEEN = ("ex_data/ply/queen_scale_transformed.ply", "ex_data/ply/queen_scale.ply")
NN_SOURCE = "icp_tpu_torch/csrc/nn.cu"
# Published H100 SXM peaks (NVIDIA's data sheet): float32 outside the tensor
# cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
LIBRARY_CALL = ('torch.cdist(q, t, compute_mode="donot_use_mm_for_euclid_dist").min(-1), '
                "unmasked: a yardstick the port never calls, not the same function")


def _say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(torch, fn, launches: int = 20, reps: int = 10) -> float:
    """Device milliseconds per call: ``launches`` calls captured in one CUDA
    graph and replayed ``reps`` times, so no host work sits between them."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * launches)


def _bits(torch, x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _compare(torch, got, want, label):
    """Exact comparison of a kernel result with the plain version's; returns
    the largest absolute difference of the finite distances."""
    sq_k, idx_k = got[0], got[1]
    sq_p, idx_p = want[0], want[1]
    if not torch.equal(idx_k, idx_p):
        bad = int((idx_k != idx_p).sum())
        raise AssertionError(f"{label}: {bad} indices differ from the plain version")
    if not torch.equal(_bits(torch, sq_k), _bits(torch, sq_p)):
        raise AssertionError(f"{label}: sq is not bit-equal to the plain version")
    if len(got) == 3 and not torch.equal(got[2], want[2]):
        raise AssertionError(f"{label}: coordinates differ from the plain version")
    both_inf = torch.isinf(sq_k) & torch.isinf(sq_p)
    diff = torch.where(both_inf, torch.zeros_like(sq_k), sq_k - sq_p).abs()
    return float(diff.max()) if diff.numel() else 0.0


def _nn_cases(torch, np, dev):
    """Inputs of phase 3: (label, timing key or None, query, targets, mask)."""
    rng = np.random.default_rng(1)

    def cloud_lanes(b, n, m, d, dtype, count_lo):
        q = torch.tensor(rng.uniform(-10, 10, (b, n, d)), dtype=dtype, device=dev)
        t = torch.tensor(rng.uniform(-10, 10, (b, m, d)), dtype=dtype, device=dev)
        counts = torch.tensor(rng.integers(count_lo, m + 1, b), device=dev)
        mask = torch.arange(m, device=dev)[None, :] < counts[:, None]
        return q, t, mask

    f32, f64 = torch.float32, torch.float64
    cases = [
        ("main fine (1024, 1024, 1024, 2) f32", "fine",
         *cloud_lanes(1024, 1024, 1024, 2, f32, 500)),
        ("main coarse (1024, 256, 256, 2) f32", "coarse",
         *cloud_lanes(1024, 256, 256, 2, f32, 125)),
    ]
    q = torch.tensor(rng.uniform(-50, 50, (8, 1000, 3)), dtype=f32, device=dev)
    t = torch.tensor(rng.uniform(-50, 50, (8, 1300, 3)), dtype=f32, device=dev)
    mask = torch.tensor(rng.uniform(size=(8, 1300)) > 0.1, device=dev)
    cases.append(("random mask (8, 1000, 1300, 3) f32", None, q, t, mask))
    base = rng.uniform(-5, 5, (64, 2)).astype(np.float32)
    q = torch.tensor(base, device=dev)[None].contiguous()
    t = torch.tensor(np.tile(base, (16, 1)), device=dev)[None].contiguous()
    cases.append(("ties: 16 copies of 64 points", None, q, t, None))
    q, t, mask = cloud_lanes(4, 300, 500, 2, f32, 1)
    mask[0] = False
    cases.append(("lane 0 all masked (4, 300, 500, 2) f32", None, q, t, mask))
    q, t, mask = cloud_lanes(3, 200, 700, 3, f64, 1)
    cases.append(("float64 (3, 200, 700, 3)", None, q, t, mask))
    cases.append(("staged M (2, 512, 40000, 2) f32", "staged",
                  *cloud_lanes(2, 512, 40000, 2, f32, 30000)))
    # The fine shape's grid with 8x the targets: two stages per lane.
    cases.append(("two stages per lane (1024, 1024, 8192, 2) f32", "two_stages",
                  *cloud_lanes(1024, 1024, 8192, 2, f32, 4000)))
    base = rng.uniform(-5, 5, (64, 2)).astype(np.float32)
    q = torch.tensor(base, device=dev)[None].contiguous()
    t = torch.tensor(np.tile(base, (400, 1)), device=dev)[None].contiguous()
    cases.append(("ties: 400 copies of 64 points, across stages", None, q, t, None))
    cases.append(("ragged N (16, 1000, 1100, 2) f32", None,
                  *cloud_lanes(16, 1000, 1100, 2, f32, 1)))
    cases.append(("ragged N (8, 300, 777, 2) f32", None, *cloud_lanes(8, 300, 777, 2, f32, 1)))
    cases.append(("lanes share a block (30, 7, 50, 2) f32", None,
                  *cloud_lanes(30, 7, 50, 2, f32, 1)))
    cases.append(("staged float64 (2, 100, 5000, 3)", None,
                  *cloud_lanes(2, 100, 5000, 3, f64, 1)))
    import icp_tpu_torch as icp
    from icp_tpu_torch import geometry

    q, t = (torch.tensor(icp.read_ply(os.path.join(REPO, p)), dtype=f32, device=dev)[None]
            for p in QUEEN)
    cases.append(("queen-scale PLY pair (1, 10720, 10720, 3) f32", "queen", q, t,
                  torch.ones(t.shape[:-1], dtype=torch.bool, device=dev)))
    # Phase 7's inputs: each scan's lanes moved by the matrix's guesses (the
    # trimmed iterate's queries), against the target lanes and their masks.
    _, _, guess = _matrix_guess(torch, np, icp, dev)
    for scan in (1, 2, 3):
        _, _, source, target = _matrix_pair(torch, icp, dev, scan)
        q = geometry.apply(guess, source.points).contiguous()
        cases.append((f"matrix scan{scan} {tuple(q.shape[:2]) + tuple(target.points.shape[1:])} "
                      "f32", None, q, target.points, target.mask))
    # Phase 8's gicp input: scan1 under the hard guesses.
    _, _, source, target = _matrix_pair(torch, icp, dev, 1)
    q = geometry.apply(_hard_guess(torch, np, icp, dev)[2], source.points).contiguous()
    cases.append(("hard guesses scan1 (256, 1024, 1024, 2) f32", None, q, target.points,
                  target.mask))
    return cases


def _time_nn(torch, q, t, mask, main: bool) -> dict:
    """K1 and K2 on these inputs: ms per call (CUDA events) and per launch
    from a CUDA graph (the device's time), each beside its bound, and the
    graph's rate over all (query, target) pairs, masked ones included, in
    tera-pairs per second.  At the main path's shapes, also the plain
    version and the library yardstick."""
    from icp_tpu_torch.ops import fused_nn, nn, pallas_nn

    def k1():
        return fused_nn.fused_nearest_neighbors(q, t, mask, return_coords=True)

    def k2():
        return pallas_nn.nearest_neighbors_pallas(q, t, mask)

    ms = {"K1": _cuda_ms(torch, k1, 20), "K2": _cuda_ms(torch, k2, 20)}
    if main:
        ms["K1_plain"] = _cuda_ms(torch, lambda: fused_nn.plain_fused_nearest_neighbors(
            q, t, mask, return_coords=True), 5)
        ms["K2_plain"] = _cuda_ms(torch, lambda: nn.nearest_neighbors(q, t, mask), 5)
    ms["K1_graph"] = _graph_ms(torch, k1)
    ms["K2_graph"] = _graph_ms(torch, k2)
    if main:
        ms["library"] = _cuda_ms(torch, lambda: torch.cdist(
            q, t, compute_mode="donot_use_mm_for_euclid_dist").min(-1), 5)
    pairs = q.shape[0] * q.shape[1] * t.shape[1]
    for k in ("K1", "K2"):
        ms[f"{k}_bound"], ms[f"{k}_bound_by"], ms["all_pairs_bound"] = _bound(
            q, t, mask, coords=k == "K1")
        ms[f"{k}_pct_of_bound"] = 100 * ms[f"{k}_bound"] / ms[k]
        ms[f"{k}_graph_Tpairs_s"] = pairs / ms[f"{k}_graph"] / 1e9
    return ms


def _ptxas_summary(text: str) -> str:
    """ptxas' report of the build, one entry per kernel instance: type, D,
    K1 (coordinates) or K2, registers, and spill stores / loads in bytes."""
    out, name, spills = [], "?", "?"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"nn_kernelI([fd])Li(\d)ELb([01])E", m.group(1))
            kernel = "K1" if t and t[3] == "1" else "K2"
            name = (f"{'float' if t[1] == 'f' else 'double'} D={t[2]} {kernel}"
                    if t else m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f"{m[1]}/{m[2]}"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{name}: {m[1]} registers, spills {spills} B")
    return "; ".join(out) if out else "no ptxas report"


def _bound(q, t, mask, coords: bool):
    """The least time in ms the card could take for one call on these
    float32 inputs, and what sets it: the valid (query, target) pairs' 3D - 1
    flops at the float32 peak, or each input read and each output written
    once at the memory rate.  Also the flops bound over all pairs."""
    b, n, d = q.shape
    valid = b * t.shape[1] if mask is None else int(mask.sum())
    flop_ms = n * valid * (3 * d - 1) / PEAK_F32_FLOPS * 1e3
    all_pairs_ms = b * n * t.shape[1] * (3 * d - 1) / PEAK_F32_FLOPS * 1e3
    ins = q.nbytes + t.nbytes + (0 if mask is None else mask.nbytes)
    outs = b * n * (q.element_size() + 4) + (q.nbytes if coords else 0)
    byte_ms = (ins + outs) / PEAK_HBM_BYTES * 1e3
    return max(flop_ms, byte_ms), "operations" if flop_ms >= byte_ms else "bytes", all_pairs_ms


def _trace(torch, run) -> str:
    """One main-path run under torch.profiler: the device's busy share of the
    run's wall time, the kernel count, and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return f"wall {wall_us / 1e3:.2f} ms; the profiler recorded no device kernels"
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -math.inf
    for lo, hi in spans:  # union of the kernels' intervals
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name[:80], [0.0, 0])
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    lines = [f"wall {wall_us / 1e3:.2f} ms, {len(kernels)} kernels, device busy "
             f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}% of wall)"]
    lines += [f"  {us / 1e3:8.3f} ms {n:6d}x  {name}" for name, (us, n) in top]
    return "\n".join(lines)


def _ms_per_call(torch, fn, calls: int = 20) -> float:
    """Milliseconds per call over ``calls`` calls ending in a synchronise
    (so the number is whichever of host dispatch or device work bounds it),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def _step_ms(torch, steps: dict) -> str:
    """Milliseconds per call of each step (:func:`_ms_per_call`)."""
    return "ms per call: " + ", ".join(
        f"{name} {_ms_per_call(torch, fn):.3f}" for name, fn in steps.items())


def _kernel_count(torch, fn) -> int:
    """Device kernels (and copies) one call of ``fn`` runs, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def _iterate_steps(torch, icp, source, target, guess) -> str:
    """Each step of one full-resolution trimmed iterate at B = 1024."""
    from icp_tpu_torch import geometry
    from icp_tpu_torch.methods.trimmed import trim_weights
    from icp_tpu_torch.ops import fused_nn
    from icp_tpu_torch.ops.rigid_fit import fit_rigid

    method = icp.from_method("trimmed", 2)
    state = method.init(source, target, guess)
    a_cur = geometry.apply(state.transform, source.points)
    sq, idx, coords = fused_nn.fused_nearest_neighbors(
        a_cur, target.points, target.mask, return_coords=True)
    sq = torch.where(source.mask, sq, torch.full_like(sq, math.inf))
    weights = trim_weights(sq, source.count, 0.9, sq.dtype)
    step = fit_rigid(a_cur, coords, weights)
    return _step_ms(torch, {
        "apply": lambda: geometry.apply(state.transform, source.points),
        "nn kernel K1": lambda: fused_nn.fused_nearest_neighbors(
            a_cur, target.points, target.mask, return_coords=True),
        "trim_weights (radix)": lambda: trim_weights(sq, source.count, 0.9, sq.dtype),
        "fit_rigid": lambda: fit_rigid(a_cur, coords, weights),
        "compose": lambda: geometry.compose(step, state.transform),
        "cost": lambda: method.cost(state),
        "whole iterate": lambda: method.iterate(state),
    })


def _reset_launches():
    from icp_tpu_torch.ops import fused_nn

    fused_nn.LAUNCHES = fused_nn.COORD_LAUNCHES = 0


def _read_launches() -> dict:
    from icp_tpu_torch.ops import fused_nn

    return {"K1": fused_nn.COORD_LAUNCHES, "K2": fused_nn.LAUNCHES - fused_nn.COORD_LAUNCHES}


def _timed_runs(run, reps: int):
    """``reps`` timed calls of ``run`` after one warm-up; the kernel launch
    counts are zeroed just before the first timed call and read just after
    it.  Returns (last result, seconds per call, launches)."""
    run()
    times = []
    for rep in range(reps):
        if rep == 0:
            _reset_launches()
        t0 = time.perf_counter()
        result = run()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            launches = _read_launches()
    return result, times, launches


def _mean_nn(torch, transform, source, target) -> float:
    """Mean Euclidean distance from the moved source's valid points to their
    nearest valid targets (``tests/test_ply_e2e.py``'s registration check)."""
    from icp_tpu_torch import geometry
    from icp_tpu_torch.ops import pallas_nn

    moved = geometry.apply(transform, source.points).contiguous()
    sq, _ = pallas_nn.nearest_neighbors_pallas(moved, target.points, target.mask)
    return float(torch.sqrt(sq[: int(source.count)]).mean())


def _iterate_steps_3d(torch, icp, source, target, dev) -> str:
    """Each step of one trimmed 3D iterate at the queen scale, and the
    quaternion fit's kernel count."""
    from icp_tpu_torch import geometry
    from icp_tpu_torch.ops import fused_nn
    from icp_tpu_torch.ops.rigid_fit import fit_rigid

    method = icp.from_method("trimmed", 3, icp.Config(max_distance=1.0))
    state = method.iterate(method.init(source, target, icp.identity(3, dtype=source.dtype,
                                                                   device=dev)))
    sq, _, coords = fused_nn.fused_nearest_neighbors(
        state.c, target.points, target.mask, return_coords=True)
    weights = ((torch.sqrt(torch.sqrt(sq)) <= 1.0) & source.mask).to(sq.dtype)
    step = fit_rigid(state.c, coords, weights, "quat")
    fit_kernels = _kernel_count(torch, lambda: fit_rigid(state.c, coords, weights, "quat"))
    iterate_kernels = _kernel_count(torch, lambda: method.iterate(state))
    return _step_ms(torch, {
        "nn kernel K1": lambda: fused_nn.fused_nearest_neighbors(
            state.c, target.points, target.mask, return_coords=True),
        "quaternion fit": lambda: fit_rigid(state.c, coords, weights, "quat"),
        "apply": lambda: geometry.apply(step, state.c),
        "compose": lambda: geometry.compose(step, state.transform),
        "whole iterate": lambda: method.iterate(state),
    }) + f"; kernels per call (torch.profiler): quaternion fit {fit_kernels}, " \
         f"whole iterate {iterate_kernels}"


def _phase_3d(torch, np, icp, dev) -> dict:
    """Phase 6: trimmed and vanilla 3D on the queen-scale pair; returns the
    K1/K2 launches of each method's run."""
    src_pts, dst_pts = (icp.read_ply(os.path.join(REPO, p)) for p in QUEEN)
    source = icp.from_points(src_pts, dtype=torch.float32, device=dev)
    target = icp.from_points(dst_pts, dtype=torch.float32, device=dev)
    s64 = icp.from_points(src_pts, dtype=torch.float64, device="cpu")
    t64 = icp.from_points(dst_pts, dtype=torch.float64, device="cpu")
    guess = icp.identity(3, dtype=torch.float32, device=dev)
    cfg = icp.DriverConfig(max_iterations=100, angle_tolerance=1e-4, translation_tolerance=1e-4)
    before = _mean_nn(torch, guess, source, target)
    launches = {}
    for name, config in (("trimmed", icp.Config(max_distance=1.0)), ("vanilla", icp.Config())):
        method = icp.from_method(name, 3, config)

        def run():
            out, _ = icp.converge(method, source, target, guess, cfg)
            float(out.transform.translation.sum())  # waits for the device
            return out

        result, times, launches[name] = _timed_runs(run, 5)
        if launches[name]["K1"] <= 0:
            raise AssertionError(f"{name} 3D did not launch K1: {launches[name]}")
        rot, trans = result.transform.rotation, result.transform.translation
        if rot.shape != (3, 3) or not (torch.isfinite(rot).all() and torch.isfinite(trans).all()):
            raise AssertionError(f"{name} 3D: bad pose {rot}, {trans}")
        after = _mean_nn(torch, result.transform, source, target)
        if name == "trimmed" and not (after < 0.05 and after < 0.2 * before):
            raise AssertionError(f"trimmed 3D: mean NN {before} -> {after}")
        if not after < before:
            raise AssertionError(f"{name} 3D: mean NN did not fall, {before} -> {after}")
        med = float(np.median(times))
        _say("3d", f"queen-scale {name} 3D B=1 f32: iterations {int(result.iteration_count)}, "
                   f"median of {len(times)} {med * 1e3:.2f} ms (runs ms "
                   f"{', '.join(f'{x * 1e3:.2f}' for x in times)}), mean NN distance "
                   f"{before:.6e} -> {after:.6e}, launches {launches[name]}")
        _say("3d-trace", f"{name}: " + _trace(torch, run))
        t0 = time.perf_counter()
        cpu, _ = icp.converge(method, s64, t64, icp.identity(3, device="cpu"), cfg)
        cpu_s = time.perf_counter() - t0
        rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        max_dt = float(torch.linalg.vector_norm(trans.double().cpu() - cpu.transform.translation))
        col_drift = float((torch.linalg.vector_norm(rot.double(), dim=-2) - 1).abs().max())
        _say("3d-pose", f"{name}: CUDA f32 (quat) vs CPU f64 (svd): |dt| {max_dt:.3e} m (gate "
                        f"{POSE_AGREEMENT_TOL_M}), rotation max ||col|-1| {col_drift:.3e}, "
                        f"iterations {int(result.iteration_count)} vs "
                        f"{int(cpu.iteration_count)}; CPU run {cpu_s:.1f} s, process peak RSS "
                        f"{rss_gib:.2f} GiB")
        if not (max_dt <= POSE_AGREEMENT_TOL_M and col_drift <= 1e-5):
            raise AssertionError(f"{name} 3D pose agreement failed: {max_dt}, {col_drift}")
    _say("3d-steps", _iterate_steps_3d(torch, icp, source, target, dev))
    return launches


def _matrix_guess(torch, np, icp, dev):
    """The bench's seeded guesses for the matrix's B = 256 lanes."""
    rng = np.random.default_rng(0)
    angles = rng.uniform(-0.05, 0.05, MATRIX_BATCH).astype(np.float32)
    shifts = rng.uniform(-0.2, 0.2, (MATRIX_BATCH, 2)).astype(np.float32)
    guess = icp.from_angle_2d(torch.tensor(angles, device=dev), torch.tensor(shifts, device=dev))
    return angles, shifts, guess


def _matrix_pair(torch, icp, dev, scan: int):
    """Scan ``scan``'s pair as the matrix runs it: B = 256 float32 lanes at
    capacity 1024, or at the scan's size rounded up to 8 where it is larger."""
    from icp_tpu_torch.cloud import round_up

    pts = [icp.io.parse_lidar_scan_array(os.path.join(REPO, f"ex_data/scan{scan}/{f}.csv"))
           for f in ("first", "second")]
    cap = max(CAPACITY, *(round_up(len(p), 8) for p in pts))
    source, target = (
        icp.stack([icp.from_points(p, capacity=cap, dtype=torch.float32, device=dev)]
                  * MATRIX_BATCH) for p in pts)
    return pts, cap, source, target


def _phase_matrix(torch, np, icp, dev) -> dict:
    """Phase 7: every reference 2D method x scans 1-3 at B = 256; returns
    each cell's launches."""
    angles, shifts, guess = _matrix_guess(torch, np, icp, dev)
    cfg = icp.DriverConfig(
        max_iterations=50, angle_tolerance=0.1 * math.pi / 180, translation_tolerance=0.01
    )
    lanes = np.arange(0, MATRIX_BATCH, MATRIX_BATCH // MATRIX_POSE_LANES)
    launches, scan1 = {}, {}
    for name in ("vanilla", "trimmed", "feature_aware"):
        method = icp.from_method(name, 2, icp.Config())
        fn = icp.make_converge_fn(method, cfg)
        for scan in (1, 2, 3):
            pts, cap, source, target = _matrix_pair(torch, icp, dev, scan)

            def run():
                out, _ = fn(source, target, guess)
                float(out.cost.sum())  # waits for the device
                return out

            torch.cuda.reset_peak_memory_stats(dev)
            result, times, cell = _timed_runs(run, 3)
            peak = torch.cuda.max_memory_allocated(dev)
            launches[f"{name}/scan{scan}"] = cell
            if name != "feature_aware" and cell["K2"] <= 0:
                raise AssertionError(f"{name} scan{scan}: init did not launch K2: {cell}")
            rot, trans = result.transform.rotation, result.transform.translation
            if not (torch.isfinite(rot).all() and torch.isfinite(trans).all()
                    and torch.isfinite(result.cost).all()):
                raise AssertionError(f"{name} scan{scan}: non-finite poses or costs")
            med = float(np.median(times))
            _say("matrix", f"{name} scan{scan} B={MATRIX_BATCH} cap {cap}: "
                           f"{MATRIX_BATCH / med:.2f} pairs/s (median of {len(times)}: "
                           f"{med * 1e3:.2f} ms; runs ms "
                           f"{', '.join(f'{x * 1e3:.2f}' for x in times)}), mean iterations "
                           f"{float(result.iteration_count.float().mean()):.4f} (max "
                           f"{int(result.iteration_count.max())}), mean cost "
                           f"{float(result.cost.mean()):.6f}, launches {cell}, peak device "
                           f"memory {peak / 2**30:.3f} GiB")
            if scan == 1:
                scan1[name] = (pts, cap, trans[torch.as_tensor(lanes, device=dev)].double().cpu())
            del source, target, result
            torch.cuda.empty_cache()
    for name, (pts, cap, t_gpu) in scan1.items():
        src, tgt = (icp.stack([icp.from_points(p, capacity=cap, device="cpu")]
                              * len(lanes)) for p in pts)
        g64 = icp.from_angle_2d(torch.tensor(angles[lanes], dtype=torch.float64),
                                torch.tensor(shifts[lanes], dtype=torch.float64))
        cpu, _ = icp.make_converge_fn(icp.from_method(name, 2), cfg)(src, tgt, g64)
        max_dt = float(torch.linalg.vector_norm(t_gpu - cpu.transform.translation, dim=-1).max())
        _say("matrix-pose", f"{name} scan1, {len(lanes)} lanes, CUDA f32 vs CPU f64: max |dt| "
                            f"{max_dt:.3e} m (gate {POSE_AGREEMENT_TOL_M})")
        if not max_dt <= POSE_AGREEMENT_TOL_M:
            raise AssertionError(f"{name} pose agreement failed: {max_dt}")
    return launches


# Phase 8: the net-new families.  (label, config, guesses): the matrix's
# guesses for the point-to-point-like families, the bench's hard fleet for
# gicp and NDT (``bench.py::run_gicp``/``run_ndt``).
FAMILY_CELLS = (
    ("point_to_plane", {}, "matrix"),
    ("robust", {}, "matrix"),
    ("symmetric", {}, "matrix"),
    ("gicp", {}, "hard"),
    ("ndt", {"cell_size": 0.5, "cells": 1024}, "hard"),
    ("ndt d2d", {"cell_size": 0.5, "cells": 1024, "variant": "d2d"}, "hard"),
)
NDT_CONVERGED_M = 0.05  # a lane within 5 cm of the trimmed pose (bench.py:317-321)
MAP_POINTS, MAP_SCAN_POINTS = 65536, 4096  # the scan-to-map cell (bench.py:499-512)


def _bench_cfg(icp):
    return icp.DriverConfig(
        max_iterations=50, angle_tolerance=0.1 * math.pi / 180, translation_tolerance=0.01)


def _hard_guess(torch, np, icp, dev):
    """``bench.py::_hard_guesses``: seed 1, +-0.15 rad, +-0.6 m, B = 256."""
    rng = np.random.default_rng(1)
    angles = rng.uniform(-0.15, 0.15, MATRIX_BATCH).astype(np.float32)
    shifts = rng.uniform(-0.6, 0.6, (MATRIX_BATCH, 2)).astype(np.float32)
    guess = icp.from_angle_2d(torch.tensor(angles, device=dev), torch.tensor(shifts, device=dev))
    return angles, shifts, guess


def _trimmed_reference(torch, icp, dev, pts):
    """The pose NDT's converged lanes are counted against: single-scale
    trimmed from the identity on the unbatched pair (bench.py:309-316)."""
    a, b = (icp.from_points(p, dtype=torch.float32, device=dev) for p in pts)
    ref, _ = icp.converge(icp.from_method("trimmed", 2), a, b,
                          icp.identity(2, dtype=torch.float32, device=dev), _bench_cfg(icp))
    return ref.transform.translation


def _family_method(icp, label, cfg_kw):
    return icp.from_method(label.split()[0], 2, icp.Config(**cfg_kw))


def _cell_line(batch, times, result):
    med = float(sorted(times)[len(times) // 2])
    return (f"{batch / med:.2f} pairs/s (median of {len(times)}: {med * 1e3:.2f} ms; runs ms "
            f"{', '.join(f'{x * 1e3:.2f}' for x in times)}), mean iterations "
            f"{float(result.iteration_count.float().mean()):.4f} (max "
            f"{int(result.iteration_count.max())}), mean cost {float(result.cost.mean()):.6f}")


def _family_matrix(torch, np, icp, dev) -> tuple[dict, dict]:
    """Phase 8a: each new family x scans 1-3 at B = 256; returns each
    cell's launches and, per family, scan1's poses of the gate lanes."""
    guesses = {"matrix": _matrix_guess(torch, np, icp, dev),
               "hard": _hard_guess(torch, np, icp, dev)}
    lanes = torch.as_tensor(np.arange(0, MATRIX_BATCH, MATRIX_BATCH // MATRIX_POSE_LANES),
                            device=dev)
    launches, scan1 = {}, {}
    for label, cfg_kw, fleet in FAMILY_CELLS:
        fn = icp.make_converge_fn(_family_method(icp, label, cfg_kw), _bench_cfg(icp))
        guess = guesses[fleet][2]
        for scan in (1, 2, 3):
            pts, cap, source, target = _matrix_pair(torch, icp, dev, scan)

            def run():
                out, _ = fn(source, target, guess)
                float(out.cost.sum())  # waits for the device
                return out

            torch.cuda.reset_peak_memory_stats(dev)
            result, times, cell = _timed_runs(run, 3)
            peak = torch.cuda.max_memory_allocated(dev)
            launches[f"{label}/scan{scan}"] = cell
            if not label.startswith("ndt") and cell["K2"] <= 0:
                raise AssertionError(f"{label} scan{scan} did not launch K2: {cell}")
            rot, trans = result.transform.rotation, result.transform.translation
            if not (torch.isfinite(rot).all() and torch.isfinite(trans).all()
                    and torch.isfinite(result.cost).all()):
                raise AssertionError(f"{label} scan{scan}: non-finite poses or costs")
            line = (f"{label} scan{scan} B={MATRIX_BATCH} cap {cap} ({fleet} guesses): "
                    f"{_cell_line(MATRIX_BATCH, times, result)}, launches {cell}, peak device "
                    f"memory {peak / 2**30:.3f} GiB")
            if label.startswith("ndt"):
                ref = _trimmed_reference(torch, icp, dev, pts)
                ok = int((torch.linalg.vector_norm(trans - ref, dim=-1) < NDT_CONVERGED_M).sum())
                line += (f", converged lanes {ok}/{MATRIX_BATCH} (within {NDT_CONVERGED_M} m of "
                         "trimmed)")
            _say("families", line)
            if scan == 1:
                scan1[label] = (pts, cap, trans[lanes].double().cpu())
            del source, target, result
            torch.cuda.empty_cache()
    return launches, scan1


def _family_pose_gates(torch, np, icp, dev, scan1) -> None:
    """Phase 8e (2D): 8 lanes of scan1 per family, CUDA float32 against CPU
    float64.  A lane over the gate is run on the CPU in float32 as well,
    from its guess and from the guess with the angle 1 ulp up and 1 ulp
    down: if one of those misses the gate too, the lane's pose is not
    determined to the gate in float32 (a float32 property of the method,
    reported); if all three meet it, the script fails."""
    lanes = np.arange(0, MATRIX_BATCH, MATRIX_BATCH // MATRIX_POSE_LANES)
    guesses = {"matrix": _matrix_guess(torch, np, icp, "cpu"),
               "hard": _hard_guess(torch, np, icp, "cpu")}
    for label, cfg_kw, fleet in FAMILY_CELLS:
        pts, cap, t_gpu = scan1[label]
        angles, shifts, _ = guesses[fleet]
        fn = icp.make_converge_fn(_family_method(icp, label, cfg_kw), _bench_cfg(icp))

        def cpu_run(dtype, which, ulps=0):
            src, tgt = (icp.stack([icp.from_points(p, capacity=cap, dtype=dtype, device="cpu")]
                                  * len(which)) for p in pts)
            angle = torch.tensor(angles[which], dtype=dtype)
            if ulps:
                angle = torch.nextafter(angle, torch.full_like(angle, ulps * math.inf))
            guess = icp.from_angle_2d(angle, torch.tensor(shifts[which], dtype=dtype))
            return fn(src, tgt, guess)[0].transform.translation.double()

        t0 = time.perf_counter()
        t64 = cpu_run(torch.float64, lanes)
        dt = torch.linalg.vector_norm(t_gpu - t64, dim=-1)
        line = (f"{label} scan1, {len(lanes)} lanes, CUDA f32 vs CPU f64: max |dt| "
                f"{float(dt.max()):.3e} m (gate {POSE_AGREEMENT_TOL_M}), CPU run "
                f"{time.perf_counter() - t0:.1f} s")
        missed = dt > POSE_AGREEMENT_TOL_M
        if missed.any():
            which = lanes[missed.numpy()]
            dt32 = torch.stack([torch.linalg.vector_norm(
                cpu_run(torch.float32, which, u) - t64[missed], dim=-1) for u in (0, 1, -1)])
            line += (f"; lanes over the gate {missed.nonzero().flatten().tolist()}, CUDA f32 |dt| "
                     f"{[f'{x:.3e}' for x in dt[missed].tolist()]}, CPU f32 |dt| from the guess, "
                     f"1 ulp up, 1 ulp down "
                     f"{[[f'{x:.3e}' for x in row] for row in dt32.T.tolist()]}")
            if (dt32.max(0).values <= POSE_AGREEMENT_TOL_M).any():
                raise AssertionError(f"{label}: CUDA f32 misses the gate on a lane that CPU f32 "
                                     f"meets from its guess and 1 ulp either side: {line}")
            line += (": each misses on the CPU in float32 too, a float32 property of the method "
                     "on these lanes")
        _say("families-pose", line)


def _iterate_profile(torch, np, icp, dev) -> None:
    """Each new family's init and iterate on scan1 at B = 256: ms per call,
    kernels per call; then a trace of 5 iterates of the slowest iterate."""
    _, _, source, target = _matrix_pair(torch, icp, dev, 1)
    guesses = {"matrix": _matrix_guess(torch, np, icp, dev)[2],
               "hard": _hard_guess(torch, np, icp, dev)[2]}
    per_iterate = {}
    for label, cfg_kw, fleet in FAMILY_CELLS:
        method = _family_method(icp, label, cfg_kw)
        guess = guesses[fleet]
        state = method.init(source, target, guess)
        init_ms = _ms_per_call(torch, lambda: method.init(source, target, guess), 5)
        iterate_ms = _ms_per_call(torch, lambda: method.iterate(state))
        per_iterate[label] = (iterate_ms, method, state)
        _say("families-steps", f"{label}: ms per call: init {init_ms:.3f}, iterate "
                               f"{iterate_ms:.3f}; kernels per call (torch.profiler): init "
                               f"{_kernel_count(torch, lambda: method.init(source, target, guess))}"
                               f", iterate {_kernel_count(torch, lambda: method.iterate(state))}")
    slowest = max(per_iterate, key=lambda k: per_iterate[k][0])
    _, method, state = per_iterate[slowest]

    def five():
        s = state
        for _ in range(5):
            s = method.iterate(s)
        float(method.cost(s).sum())

    _say("families-trace", f"{slowest} (slowest iterate), 5 iterates: " + _trace(torch, five))


def _chained_ms(torch, method, state0, n: int = 50, reps: int = 3) -> float:
    """Best of ``reps`` mean ms per iterate over ``n`` chained iterates (the
    queen protocol, ``bench.py:264-290``), after one warm-up chain."""
    best = math.inf
    for rep in range(reps + 1):
        state = state0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state = method.iterate(state)
        float(method.cost(state).sum())
        if rep:
            best = min(best, (time.perf_counter() - t0) / n * 1e3)
    return best


def _queen_gicp(torch, icp, dev) -> dict:
    """Phase 8c: 3D gicp at queen scale; returns the launches of 50 chained
    iterates."""
    src_pts, dst_pts = (icp.read_ply(os.path.join(REPO, p)) for p in QUEEN)
    source = icp.from_points(src_pts, dtype=torch.float32, device=dev)
    target = icp.from_points(dst_pts, dtype=torch.float32, device=dev)
    method = icp.from_method("gicp", 3, icp.Config(dim=3, neighbors=10, normal_neighbors=10))
    pre = []
    for rep in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cov = method.precompute(target)
        float(cov.sum())
        if rep:
            pre.append((time.perf_counter() - t0) * 1e3)
    state0 = method.init(source, target, icp.identity(3, dtype=torch.float32, device=dev))
    ms = _chained_ms(torch, method, state0)
    _reset_launches()
    state = state0
    for _ in range(50):
        state = method.iterate(state)
    float(method.cost(state).sum())
    launches = _read_launches()
    if launches["K2"] != 50:
        raise AssertionError(f"queen gicp: 50 iterates launched {launches}")
    if not torch.isfinite(state.transform.translation).all():
        raise AssertionError("queen gicp: non-finite pose")
    kernels = _kernel_count(torch, lambda: method.iterate(state0))

    def five():
        s = state0
        for _ in range(5):
            s = method.iterate(s)
        float(method.cost(s).sum())

    before = _mean_nn(torch, state0.transform, source, target)
    after = _mean_nn(torch, state.transform, source, target)
    _say("gicp3d", f"queen-scale gicp 3D (10,720 points, neighbors 10) f32: precompute (surfel "
                   f"covariances of one cloud) ms {', '.join(f'{x:.2f}' for x in pre)}; "
                   f"{ms:.3f} ms per GN iterate (best of 3 chains of 50); kernels per iterate "
                   f"{kernels}; 50 iterates launched {launches}; mean NN distance {before:.6e} "
                   f"-> {after:.6e} after 50")
    _say("gicp3d-trace", "5 chained iterates: " + _trace(torch, five))
    return launches


def _scan_to_map(torch, np, icp, dev) -> None:
    """Phase 8d: 3D NDT, a 4,096-point scan against a 65,536-point sphere
    map (bench.py:499-512, seed 13), cell 1.0, 8,192 slots."""
    from icp_tpu_torch.ops import ndt

    rng = np.random.default_rng(13)
    u = rng.normal(size=(MAP_POINTS, 3)).astype(np.float32)
    map_pts = 20.0 * u / np.linalg.norm(u, axis=1, keepdims=True)
    v = rng.normal(size=(MAP_SCAN_POINTS, 3)).astype(np.float32)
    v[:, 2] = np.abs(v[:, 2])  # upper-cap scan
    scan_pts = 20.0 * v / np.linalg.norm(v, axis=1, keepdims=True)
    scan_pts += rng.normal(0, 0.02, scan_pts.shape).astype(np.float32)
    source = icp.from_points(scan_pts, dtype=torch.float32, device=dev)
    target = icp.from_points(map_pts, dtype=torch.float32, device=dev)
    cfg = {"dim": 3, "cell_size": 1.0, "cells": 8192}
    dense = icp.from_method("ndt", 3, icp.Config(**cfg))
    build = []
    for rep in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps = dense.precompute(target)
        overflowed = bool(maps.overflowed.any())
        if rep:
            build.append((time.perf_counter() - t0) * 1e3)
    if overflowed:
        raise AssertionError(f"scan-to-map: the {MAP_POINTS}-point map overflowed 8,192 slots")
    q = source.points[None].expand(maps.keys.shape[0], *source.points.shape)
    d, s = ndt.lookup_cells_dense(q, maps), ndt.lookup_cells(q, maps)
    hit = s[2]
    if not (torch.equal(d[2], hit) and all(torch.equal(d[i][hit], s[i][hit]) for i in (0, 1, 3))):
        raise AssertionError("scan-to-map: dense and sorted lookups differ")
    ident = icp.identity(3, dtype=torch.float32, device=dev)
    per = {}
    for lookup in ("dense", "sorted"):
        method = icp.from_method("ndt", 3, icp.Config(lookup=lookup, **cfg))
        state0 = method.with_precomputed(None, maps).init(source, target, ident)
        per[lookup] = _chained_ms(torch, method, state0)
    _say("scan-to-map", f"{MAP_POINTS}-point map, 8 grids, {int(maps.valid.sum())} valid cells: "
                        f"build ms {', '.join(f'{x:.2f}' for x in build)}, no overflow; lookups "
                        f"of the {MAP_SCAN_POINTS}-point scan: {int(hit.sum())} hits, dense == "
                        f"sorted; ms per "
                        f"iterate (best of 3 chains of 50): dense {per['dense']:.3f}, sorted "
                        f"{per['sorted']:.3f}")


def _pose_gates_3d(torch, icp, dev) -> None:
    """Phase 8e (3D): point_to_plane and gicp on the 1,800-point torus pair,
    CUDA float32 against CPU float64."""
    a, b = (icp.read_ply(os.path.join(REPO, f"ex_data/ply/{f}"))
            for f in ("torus_transformed.ply", "torus.ply"))
    cfg = icp.DriverConfig(max_iterations=100, angle_tolerance=1e-4, translation_tolerance=1e-4)
    for name, kw in (("point_to_plane", {}), ("gicp", {"neighbors": 10})):
        method = icp.from_method(name, 3, icp.Config(**kw))
        out = {}
        for d, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
            out[str(d)], _ = icp.converge(
                method, icp.from_points(a, dtype=dtype, device=d),
                icp.from_points(b, dtype=dtype, device=d), icp.identity(3, dtype=dtype, device=d),
                cfg)
        gpu, cpu = out[str(dev)], out["cpu"]
        dt = float(torch.linalg.vector_norm(gpu.transform.translation.double().cpu()
                                            - cpu.transform.translation))
        _say("families-pose", f"{name} 3D torus pair: CUDA f32 vs CPU f64 |dt| {dt:.3e} m (gate "
                              f"{POSE_AGREEMENT_TOL_M}), iterations "
                              f"{int(gpu.iteration_count)} vs {int(cpu.iteration_count)}")
        if not dt <= POSE_AGREEMENT_TOL_M:
            raise AssertionError(f"{name} 3D pose agreement failed: {dt}")


def _phase_families(torch, np, icp, dev) -> dict:
    """Phase 8: the net-new families; returns the launches of each path."""
    from icp_tpu_torch.multiscale import converge_ndt_multiscale

    launches, scan1 = _family_matrix(torch, np, icp, dev)
    paths = {f"families {k}": v for k, v in launches.items()}
    _, _, guess = _hard_guess(torch, np, icp, dev)
    pts, _, source, target = _matrix_pair(torch, icp, dev, 1)

    def run():
        out, _ = converge_ndt_multiscale(
            source, target, guess, _bench_cfg(icp), dim=2,
            ndt_config=icp.Config(cell_size=0.5, cells=1024), scales=(8.0, 2.0),
            coarse_max_iterations=6)
        float(out.cost.sum())
        return out

    result, times, paths["ndt multiscale/scan1"] = _timed_runs(run, 3)
    ref = _trimmed_reference(torch, icp, dev, pts)
    ok = int((torch.linalg.vector_norm(result.transform.translation - ref, dim=-1)
              < NDT_CONVERGED_M).sum())
    _say("ndt-multiscale", f"scan1 8x -> 2x -> 1x cells (coarse cap 6, no coarse init), hard "
                           f"guesses, B={MATRIX_BATCH}: {_cell_line(MATRIX_BATCH, times, result)} "
                           f"(fine level), converged lanes {ok}/{MATRIX_BATCH}")
    del source, target
    _iterate_profile(torch, np, icp, dev)
    paths["gicp 3d queen, 50 iterates"] = _queen_gicp(torch, icp, dev)
    _scan_to_map(torch, np, icp, dev)
    torch.cuda.empty_cache()
    _family_pose_gates(torch, np, icp, dev, scan1)
    _pose_gates_3d(torch, icp, dev)
    return paths


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    sys.path.insert(0, REPO)
    import icp_tpu_torch as icp
    from icp_tpu_torch import _build
    from icp_tpu_torch.ops import fused_nn, nn, pallas_nn

    phase_s = {}
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        phase_s[name] = round(time.perf_counter() - t_phase, 2)
        t_phase = time.perf_counter()

    # Phase 1: device and TF32.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on; the package must turn it off")
    _say("device", f"{kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, TF32 off")
    dev = torch.device("cuda", 0)
    phase_done("1 device")

    # Phase 2: build.
    t0 = time.perf_counter()
    was_built = _build.library_path("nn").exists()
    _build.load("nn")
    build_s = time.perf_counter() - t0
    _say("build", f"{NN_SOURCE} {'loaded' if was_built else 'built'} in {build_s:.2f} s")
    _say("ptxas", _ptxas_summary(_build.ptxas_log("nn").read_text()))
    phase_done("2 build")

    # Phase 3: kernel vs plain version.
    errs = {"K1": 0.0, "K2": 0.0}
    timed, exact_cases = {}, []
    for label, key, q, t, mask in _nn_cases(torch, np, dev):
        k1 = fused_nn.fused_nearest_neighbors(q, t, mask, return_coords=True)
        p1 = fused_nn.plain_fused_nearest_neighbors(q, t, mask, return_coords=True)
        k2 = pallas_nn.nearest_neighbors_pallas(q, t, mask)
        p2 = nn.nearest_neighbors(q, t, mask)
        torch.cuda.synchronize()
        errs["K1"] = max(errs["K1"], _compare(torch, k1, p1, f"K1 {label}"))
        errs["K2"] = max(errs["K2"], _compare(torch, k2, p2, f"K2 {label}"))
        exact_cases.append(label)
        line = f"{label}: K1 and K2 exact (idx, coords, sq bits)"
        if label.startswith("ties"):
            if int(k1[1].max()) >= 64 or int(k2[1].max()) >= 64:
                raise AssertionError("ties: a later copy won over the first")
            line += ", first copy wins"
        if label.startswith("lane 0"):
            if not (torch.isinf(k1[0][0]).all() and (k1[1][0] == 0).all()):
                raise AssertionError("all-masked lane must give (inf, 0)")
            line += ", masked lane (inf, 0)"
        if key is not None:
            ms = _time_nn(torch, q, t, mask, main=key in ("fine", "coarse", "queen"))
            line += "; " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in ms.items())
            timed[key] = ms
        _say("kernel", line)
        del k1, p1, k2, p2
    torch.cuda.empty_cache()
    phase_done("3 kernels")

    # Phase 4: the main path.
    data = os.path.join(REPO, "ex_data")
    a_pts = icp.io.parse_lidar_scan_array(f"{data}/scan1/first.csv")
    b_pts = icp.io.parse_lidar_scan_array(f"{data}/scan1/second.csv")
    a1 = icp.from_points(a_pts, capacity=CAPACITY, dtype=torch.float32, device=dev)
    b1 = icp.from_points(b_pts, capacity=CAPACITY, dtype=torch.float32, device=dev)
    source, target = icp.stack([a1] * BATCH), icp.stack([b1] * BATCH)
    rng = np.random.default_rng(0)
    angles = rng.uniform(-0.05, 0.05, BATCH).astype(np.float32)
    shifts = rng.uniform(-0.2, 0.2, (BATCH, 2)).astype(np.float32)
    guess = icp.from_angle_2d(torch.tensor(angles, device=dev), torch.tensor(shifts, device=dev))
    method = icp.from_method("trimmed", 2, icp.Config(overlap_rate=0.9))
    cfg = icp.DriverConfig(
        max_iterations=50, angle_tolerance=0.1 * math.pi / 180, translation_tolerance=0.01
    )

    def run():
        out, _ = icp.converge_multiscale(
            method, source, target, guess, cfg, factors=(4,), coarse_max_iterations=30
        )
        float(out.cost.sum())  # waits for the device
        return out

    result, times, launches = _timed_runs(run, 5)
    if min(launches.values()) <= 0:
        raise AssertionError(f"the main path did not launch every kernel: {launches}")
    rot, trans = result.transform.rotation, result.transform.translation
    if rot.shape != (BATCH, 2, 2) or trans.shape != (BATCH, 2):
        raise AssertionError(f"pose shapes {tuple(rot.shape)}, {tuple(trans.shape)}")
    if not (torch.isfinite(rot).all() and torch.isfinite(trans).all()):
        raise AssertionError("non-finite poses")
    if not torch.isfinite(result.cost).all():
        raise AssertionError("non-finite costs")
    iters = result.iteration_count
    if int(iters.max()) > cfg.max_iterations:
        raise AssertionError(f"a lane ran {int(iters.max())} > {cfg.max_iterations} iterations")
    med = float(np.median(times))
    _say(
        "main",
        f"scan1 trimmed multiscale B={BATCH}: {BATCH / med:.2f} pairs/s "
        f"(median of {len(times)}: {med * 1e3:.2f} ms; runs ms "
        f"{', '.join(f'{x * 1e3:.2f}' for x in times)}), "
        f"mean iterations {float(iters.float().mean()):.4f}, "
        f"mean cost {float(result.cost.mean()):.6f}, launches {launches}",
    )

    _say("trace", _trace(torch, run))
    _say("steps", _iterate_steps(torch, icp, source, target, guess))
    phase_done("4 main path")

    # Phase 5: pose agreement with the CPU float64 run.
    lanes = np.arange(0, BATCH, BATCH // POSE_LANES)
    a64 = icp.from_points(a_pts, capacity=CAPACITY, dtype=torch.float64, device="cpu")
    b64 = icp.from_points(b_pts, capacity=CAPACITY, dtype=torch.float64, device="cpu")
    guess64 = icp.from_angle_2d(
        torch.tensor(angles[lanes], dtype=torch.float64),
        torch.tensor(shifts[lanes], dtype=torch.float64),
    )
    t0 = time.perf_counter()
    cpu, _ = icp.converge_multiscale(
        method, icp.stack([a64] * len(lanes)), icp.stack([b64] * len(lanes)), guess64, cfg,
        factors=(4,), coarse_max_iterations=30,
    )
    cpu_s = time.perf_counter() - t0
    t_gpu = trans[torch.as_tensor(lanes, device=dev)].double().cpu()
    max_dt = float(torch.linalg.vector_norm(t_gpu - cpu.transform.translation, dim=-1).max())
    col_drift = float((torch.linalg.vector_norm(rot.double(), dim=-2) - 1).abs().max())
    same_iters = int((iters[torch.as_tensor(lanes, device=dev)].cpu() == cpu.iteration_count).sum())
    _say(
        "pose",
        f"{len(lanes)} lanes, CUDA f32 vs CPU f64: max |dt| {max_dt:.3e} m "
        f"(gate {POSE_AGREEMENT_TOL_M}), rotation max ||col|-1| {col_drift:.3e}, "
        f"equal iteration counts {same_iters}/{len(lanes)}, CPU run {cpu_s:.1f} s",
    )
    if not max_dt <= POSE_AGREEMENT_TOL_M:
        raise AssertionError(f"pose agreement failed: {max_dt} > {POSE_AGREEMENT_TOL_M}")
    del source, target, result, rot, trans
    torch.cuda.empty_cache()
    phase_done("5 pose")

    # Phase 6: the 3D path; phase 7: the 2D method matrix.
    paths = {"trimmed_2d_multiscale": launches}
    for name, cell in _phase_3d(torch, np, icp, dev).items():
        paths[f"{name}_3d"] = cell
    phase_done("6 3d path")
    for name, cell in _phase_matrix(torch, np, icp, dev).items():
        paths[f"matrix {name}"] = cell
    phase_done("7 matrix")
    paths.update(_phase_families(torch, np, icp, dev))
    phase_done("8 families")
    _say("seconds", ", ".join(f"phase {k} {v}" for k, v in phase_s.items()))

    def entry(k, name, replaces):
        fine, coarse, queen = timed["fine"], timed["coarse"], timed["queen"]
        out = {
            "name": name, "route": "cuda", "source": NN_SOURCE, "replaces": replaces,
            "launches": launches[k],
            "launches_by_path": {path: cell[k] for path, cell in paths.items()},
            "max_abs_err": errs[k], "exact_cases": exact_cases, "ms": fine[k],
            "graph_ms": fine[f"{k}_graph"], "plain_ms": fine[f"{k}_plain"],
            "bound_ms": fine[f"{k}_bound"], "bound_by": fine[f"{k}_bound_by"],
            "pct_of_bound": fine[f"{k}_pct_of_bound"],
            "all_pairs_bound_ms": fine["all_pairs_bound"], "library_ms": fine["library"],
            "library_call": LIBRARY_CALL, "coarse_ms": coarse[k],
            "coarse_graph_ms": coarse[f"{k}_graph"], "coarse_plain_ms": coarse[f"{k}_plain"],
            "coarse_bound_ms": coarse[f"{k}_bound"],
            "coarse_library_ms": coarse["library"],
            "queen_ms": queen[k], "queen_graph_ms": queen[f"{k}_graph"],
            "queen_plain_ms": queen[f"{k}_plain"], "queen_bound_ms": queen[f"{k}_bound"],
            "queen_bound_by": queen[f"{k}_bound_by"],
            "queen_pct_of_bound": queen[f"{k}_pct_of_bound"],
            "queen_library_ms": queen["library"],
        }
        for shape in ("staged", "two_stages"):
            out[f"{shape}_ms"] = timed[shape][k]
            out[f"{shape}_graph_ms"] = timed[shape][f"{k}_graph"]
            out[f"{shape}_bound_ms"] = timed[shape][f"{k}_bound"]
        return out

    kernels = [entry("K1", "nn_coords (K1)", "icp_tpu/ops/fused_nn.py:70"),
               entry("K2", "nn (K2)", "icp_tpu/ops/pallas_nn.py:48")]
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
