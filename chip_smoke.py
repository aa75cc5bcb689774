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
   (SVD; in a worker process, queued at the start): translation within
   2e-3 m, rotation columns unit to 1e-5.
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

9. The front end (float32 on the card; each path against CPU runs of the
   port computed by worker processes while the card runs phases 3-9):
   (a) all 120 seq1 sweeps chained, 119 pairs in one batch, trimmed to
   1e-6 (plain, ``coarse=``, ``multiscale=``): pairs/s (median of 3), the
   per-step error against the ground truth, ATE and RPE through ``eval``;
   every pose within 2e-3 m of CPU float64; (b) ``stream_odometry`` and
   ``stream_odometry_pipelined`` over 32 sweeps: ms/scan (median of 3
   interleaved), keyframe flags equal to CPU float64, poses gated; (c)
   scan-to-map over seq1, robust with the host and the device map (120
   sweeps) and trimmed (32): ms/scan, map points, launches by target count
   (M = 8,192), error against the ground truth, poses gated over the first
   10 sweeps (a miss counts as float32's only if the CPU float32 run misses
   too); then the 65,536-point map merge on the card against the host
   ``LocalMap``, equal as sets; (d) the server (``bench.py::run_serving``):
   low-load p50, bursts of 512 x 3 (p50, p99, pairs/s), every served pose
   equal to a direct batched converge to 1e-5 m; (e) the 72 seq3d sweeps,
   gicp 3D chain with the precompute cache, and ``coarse_align_3d`` on the
   71 pairs (one K2 launch); poses gated over the first 24 sweeps; (f)
   ``coarse_align_2d`` + trimmed on 1,024 scan1 lanes turned in +-pi:
   converged lanes on the card and (every 4th lane) on the CPU, each card
   guess within one histogram bin of the CPU float64 guess.

10. The pose-graph back end (float32 on the card): (a) ``read_g2o`` ->
   ``optimize(solver='pcg')`` on m600 and m3500 (30 GN x 50 PCG) and
   sphere2500 (40 x 60): chi² before and after, ms and kernels per GN
   iteration, the busy share of a traced 3-iteration solve, the JAX tests' bounds
   (``tests/test_manhattan_g2o.py``), poses against CPU float64 (a miss
   counts as float32's only if CPU float32 misses too) and two card runs
   against each other; (b) the 10k-node / 30k-edge synthetic graph of
   ``bench.py::run_pose_graph`` (5 GN x 50 PCG): ms per GN iteration, cost
   drop, kernels, busy share, peak memory; (c) m600 robust: gnc_gm + pcg at
   the auto scale on the loop-like edges (~1.79, chi² ~1.3e3), two-pass
   welsch (``robust_solve``) and ``robust_solve_fused`` against it, one
   outlier-protocol cell (random, 0.2, welsch, 2 passes, seed 3: recall and
   inliers kept 1.0); (d) offline loop closure over the 240
   ``ex_data/seq2loop`` sweeps, the kernel path: parse at capacity 1,024,
   the trimmed chain (to 1e-6), loop candidates (radius 2, separation 10),
   every candidate registered in one batch, the graph (loop weight 100)
   and a two-pass welsch solve on the closures: ms and K1/K2 launches per
   stage, ATE / RPE against the ground truth before and after, every 8th
   closure and the card's own graph against CPU runs (float64; float32
   where a row misses the gate), and K1 / K2 exact on the batch as run.

11. Online SLAM and place recognition (float32 on the card;
   ``bench.py::run_online_slam`` on ``ex_data/seq2loop``, ``run_descriptor``):
   (a) ``slam.OnlineSlam`` over the 240 sweeps at capacity 1,024 in the
   bench's configuration (trimmed, overlap 0.9; keyframes at 0.5 m / 0.15
   rad; ``loop_every`` 8, radius 2, separation 10; gnc_gm at the auto scale;
   odometry and loop weight 100) with the seq2loop test's driver (50
   iterations a scan), serial and pipelined, each a warm-up over
   the first 24 sweeps and a timed pass: add_scan p50 and p99 (the median
   of the passes'), the refine stall (the slowest refining scan), keyframes,
   closures, K1/K2 launches; gates: keyframe ATE <= 0.3 m against the ground
   truth, a closure accepted before scan 160, keyframe indices and poses
   after 176 sweeps against CPU float64 runs of the port (a pool of their
   own, queued at the start; a stream over the gate counts as float32's only
   if CPU float32 runs, from the sweeps and from the sweeps moved one ulp,
   miss it too and the card stays within twice their deviation); (b)
   ``scan_context`` over 1,024 scans of 1,024 points (20 x 60, radius 30)
   and the 1,024-keyframe all-pairs retrieval, CUDA events, median of 5; 64
   query rows against CPU float64 (distances to 1e-5, shifts equal where
   the best leads the next by more than 1e-5); (c) ``relocalize`` of 8 lap-2
   sweeps against the serial session's lap-1 keyframes, no pose prior,
   descriptor range 30: matches and pose errors against the ground truth;
   (d) ``merge_sessions`` of the two laps as descriptor-mode sessions with
   ``anchor=None``: the recovered anchor (the ground truth is the identity)
   and the merged keyframe ATE.

12. Asynchronous refinement and the user surfaces: (a) phase 11a's stream
   with ``OnlineSlam(async_refine=True)`` (``bench.py::run_online_slam``'s
   ``pipelined_async`` row, and serial) as users run it, timed right after
   11a and 11b over the first SLAM_GATED sweeps: add_scan p50 / p99 and
   the worst scan beside 11a's over the same sweeps, corrections applied
   mid-stream and at ``finalize``, the worker's device ms per solve (the
   session's CUDA events), K1/K2 launches; gates: keyframe ATE <= 0.3 m,
   a correction applied mid-stream.  Then each mode with the timing pinned (each solve waited
   for before the next scan) over the first SLAM_GATED sweeps, in two card
   worker processes: keyframe indices and closures equal to 11a's capture
   and keyframe translations within 2e-3 m (a pipelined miss counts as
   float32's only if the CPU float32 pinned run misses its own synchronous
   run too); (b) the 240 sweeps as CSV scans through the native loader and
   the Python parser, equal; (c) ``utils/profiling.trace`` of one main-path
   call: the kernel launches and copies the host issued, the ATen ops and
   the K1/K2 launches equal phase 4's pass (its device events beside, not
   gated: CUPTI loses some of their records as the process ages), and
   ``nn_roofline``; (d) ``cli view`` on scan1 trimmed, 20 iterations on
   the card, the last frame within 2e-3 m of CPU float64
   (without matplotlib, the frame stepping alone), and ``cli bench`` on
   scans 1-3; (e) the nine examples as subprocesses at
   ``ICP_EXAMPLES_QUICK=1``, each exiting 0 with its key line.  The pinned
   streams and the examples run beside 11c, 11d, 12c and 12d's view.

13. The parallel layer (``icp_tpu_torch.parallel``): (a) in a process of
   its own, at world size 1 on NCCL: the fleet example at full size
   (robust 2D, 64 pairs); phase 4's 1,024 lanes at full resolution through
   ``make_sharded_converge_fn`` on mesh (1, 1), points off and on, bit-equal
   to ``converge`` (pairs/s of the three, median of 3 interleaved);
   ``big_cloud_converge`` on the queen pair, ungated and gated at 1.0,
   gather and ring, 10 iterations by SVD: ring bit-equal to gather, within
   float32 rounding (2e-5) of the card's vanilla / trimmed 3D iterate and
   within 2e-3 m of the CPU float64 iterate (pool tasks queued at the
   start), ms per iteration; ``sharded_nearest_neighbors`` and
   ``ring_nearest_neighbors`` at the queen shape equal to K2; m3500 through
   ``shard_over_edges`` + PCG (phase 10a's 30 x 50) against the unsharded
   solve, ms per GN iteration of both.  (b) Four gloo ranks on the one card,
   started beside (a) and released after it: the NN merges over 4 target
   blocks and with every target in each block (ties) equal to K2; big cloud
   gather and ring over 4 point blocks within float32 rounding of (a); the
   lanes over 4 data ranks bit-equal to ``converge`` on each rank's 256
   lanes, and against (a)'s one batch of 1,024 (iterations equal, within
   1e-6 m, where the lane stops on the same iteration).  Four processes on
   one card measure nothing about scaling.

Phase 3 also runs K1 and K2 on the queen-scale pair itself,
(1, 10720, 10720, 3) float32, timed beside its bound, the plain version and
the library yardstick, and on phase 7's inputs (scans 1-3 at B = 256 under
its guesses: (256, 1024, 1024, 2) and scan2's (256, 1096, 1096, 2), whose
last query block is ragged), scan1 under phase 8's hard guesses, and phase
9's shapes (the seq1 chain's 119 pairs, a 1,024-point scan against an
8,192-point map, the 71 seq3d pairs at 2,048 in 3D), phase 10's seq2loop
closure batch (its candidates on the ground-truth trajectory) and phase
11's shapes (the B = 1 scan-to-keyframe step, a 16-lane closure batch),
exact.
Each phase prints its seconds; the kernels line lists every case held exact
and the launches of every path.

Any failure raises (non-zero exit).  The line before the last is a JSON
object of the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import io
import json
import math
import os
import re
import resource
import socket
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
    # Phase 9's shapes: the seq1 chain's pairs, a scan against a full map,
    # and the seq3d pairs (coarse_align_3d stacks four times as many lanes).
    seq1 = _stack(icp, _seq1(np)[0], "bucket", f32, dev)
    cases.append((f"seq1 chain pairs ({len(seq1.count) - 1}, {seq1.capacity}, {seq1.capacity}, "
                  "2) f32", None,
                   seq1.points[:-1], seq1.points[1:].contiguous(), seq1.mask[1:].contiguous()))
    cases.append((f"scan-to-map (1, {CAPACITY}, {MAP_CAPACITY}, 2) f32", None,
                  *cloud_lanes(1, CAPACITY, MAP_CAPACITY, 2, f32, 3000)))
    seq3d = _stack(icp, _seq3d(np)[0], "bucket", f32, dev)
    cases.append((f"seq3d pairs ({len(seq3d.count) - 1}, {seq3d.capacity}, {seq3d.capacity}, "
                  "3) f32", None, seq3d.points[:-1], seq3d.points[1:].contiguous(),
                  seq3d.mask[1:].contiguous()))
    # Phase 10's shape: the seq2loop closure batch.
    cases.append(_closure_case(torch, np, icp, dev))
    # Phase 11's shapes: OnlineSlam's B = 1 scan-to-keyframe step (seq2loop
    # sweep 10 as the keyframe, sweep 11 the scan, from the identity) and a
    # closure batch of loop_max_candidates = 16 lanes (the first 16 above).
    sweeps = _seq2loop(np)[0]
    key, scan = (icp.from_points(sweeps[i], capacity=CAPACITY, dtype=f32, device=dev)
                 for i in (10, 11))
    cases.append((f"slam scan-to-keyframe step (1, {CAPACITY}, {CAPACITY}, 2) f32", None,
                  key.points[None].contiguous(), scan.points[None].contiguous(),
                  scan.mask[None].contiguous()))
    _, _, q, t, m = cases[-2]
    cases.append((f"slam closure batch (16, {CAPACITY}, {CAPACITY}, 2) f32", None,
                  q[:16].contiguous(), t[:16].contiguous(), m[:16].contiguous()))
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


def _trace(torch, run, events=False):
    """One main-path run under torch.profiler: the device's busy share of the
    run's wall time, the kernel count, and the kernels by device time (with
    ``events``, also the device and the host events by name)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        text = f"wall {wall_us / 1e3:.2f} ms; the profiler recorded no device kernels"
        return (text, _trace_events(torch, prof)) if events else text
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
    return ("\n".join(lines), _trace_events(torch, prof)) if events else "\n".join(lines)


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


QUEEN_METHODS = (("trimmed", {"max_distance": 1.0}), ("vanilla", {}))
QUEEN_DRIVER = dict(max_iterations=100, angle_tolerance=1e-4, translation_tolerance=1e-4)


def _phase6_reference(name: str) -> dict:
    """Pool task: phase 6's CPU float64 run (SVD) of ``name`` 3D on the
    queen-scale pair, queued at the start so that it runs beside phases
    1-6."""
    sys.path.insert(0, REPO)
    import icp_tpu_torch as icp

    src_pts, dst_pts = (icp.read_ply(os.path.join(REPO, p)) for p in QUEEN)
    method = icp.from_method(name, 3, icp.Config(**dict(QUEEN_METHODS)[name]))
    t0 = time.perf_counter()
    out, _ = icp.converge(method, icp.from_points(src_pts, device="cpu"),
                          icp.from_points(dst_pts, device="cpu"), icp.identity(3, device="cpu"),
                          icp.DriverConfig(**QUEEN_DRIVER))
    return {"translation": out.transform.translation.numpy(),
            "iterations": int(out.iteration_count), "seconds": time.perf_counter() - t0}


def _phase_3d(torch, np, icp, dev, refs) -> dict:
    """Phase 6: trimmed and vanilla 3D on the queen-scale pair; returns the
    K1/K2 launches of each method's run."""
    src_pts, dst_pts = (icp.read_ply(os.path.join(REPO, p)) for p in QUEEN)
    source = icp.from_points(src_pts, dtype=torch.float32, device=dev)
    target = icp.from_points(dst_pts, dtype=torch.float32, device=dev)
    guess = icp.identity(3, dtype=torch.float32, device=dev)
    cfg = icp.DriverConfig(**QUEEN_DRIVER)
    before = _mean_nn(torch, guess, source, target)
    launches = {}
    for name, config in QUEEN_METHODS:
        method = icp.from_method(name, 3, icp.Config(**config))

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
        cpu = refs[f"3d {name}"].get()
        rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        max_dt = float(np.linalg.norm(trans.double().cpu().numpy() - cpu["translation"]))
        col_drift = float((torch.linalg.vector_norm(rot.double(), dim=-2) - 1).abs().max())
        _say("3d-pose", f"{name}: CUDA f32 (quat) vs CPU f64 (svd): |dt| {max_dt:.3e} m (gate "
                        f"{POSE_AGREEMENT_TOL_M}), rotation max ||col|-1| {col_drift:.3e}, "
                        f"iterations {int(result.iteration_count)} vs {cpu['iterations']}; CPU "
                        f"run {cpu['seconds']:.1f} s (a worker process), process peak RSS "
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




# Phase 9: the odometry front end and the server, after
# tests/test_seq1_odometry.py:57-73 (the chains), bench.py::run_streaming
# (:1168-1245), run_mapping (:1480-1530), run_serving (:1062-1165) and
# tests/test_seq3d_odometry.py (the seq3d gicp chain).
SEQ1 = "ex_data/seq1"
SEQ3D = "ex_data/seq3d"
CHAIN_CFG = dict(max_iterations=150, angle_tolerance=1e-6, translation_tolerance=1e-6)
CHAIN_MODES = ("plain", "coarse", "multiscale")
SEQ3D_CFG = dict(max_iterations=60, angle_tolerance=1e-5, translation_tolerance=1e-5)
# The CPU float64 gicp chain covers the first SEQ3D_GATED sweeps: pair t
# reads only scans t and t + 1, so those poses are the same computation.
SEQ3D_GATED = 24
GICP_3D = dict(dim=3, neighbors=10, normal_neighbors=10)
STREAM_SCANS, STREAM_TRANSLATION, STREAM_ANGLE = 32, 0.5, 0.1
STREAMS = ("stream_odometry", "stream_odometry_pipelined")
MAP_CAPACITY, VOXEL = 8192, 0.1
# (label, method, sweeps, device_map), under CHAIN_CFG (at the bench's 1 cm
# tolerance robust loses seq1 within ten sweeps): robust is the method the
# mapping module recommends; trimmed puts K1 on the map-sized (staged)
# target.  The CPU runs cover the first S2M_GATED sweeps (scan-to-map is
# causal, so those poses are the same computation); float32's voxel
# assignment moves poses by mm over a few dozen sweeps, so a miss there
# counts as float32's only if the CPU float32 run misses too.
S2M_RUNS = (("robust host map", "robust", 120, False),
            ("robust device map", "robust", 120, True),
            ("trimmed host map", "trimmed", 32, False))
S2M_GATED = 10
MERGE_MAP, MERGE_SCAN, MERGE_VOXEL = 65536, 4096, 0.2
SERVE_BURST, SERVE_BATCH, SERVE_DELAY, SERVE_TOL_M = 512, 64, 0.005, 1e-5
COARSE_LANES, COARSE_CPU_STRIDE = 1024, 4
HIST_BIN = 2 * math.pi / 180  # coarse_align_2d's 180 bins
# The CPU runs phase 9 is held against, longest first; REFERENCE_WORKERS
# processes compute them while the card runs phases 3-9 (and then phase 10's).
REFERENCE_TASKS = ("chains", "seq3d", "coarse2d", "scan_to_map", "scan_to_map_f32", "streams")
REFERENCE_WORKERS = 3


def _seq1(np):
    """The 120 seq1 sweeps as (n, 2) arrays, and the ground-truth poses
    (x, y, theta)."""
    import glob

    from icp_tpu_torch.io import parse_sweep_conf, sweep_to_points

    paths = sorted(glob.glob(os.path.join(REPO, SEQ1, "sweep_*.conf")))
    with open(os.path.join(REPO, SEQ1, "groundtruth.json")) as f:
        gt = np.asarray(json.load(f)["poses"])
    return [sweep_to_points(parse_sweep_conf(p)) for p in paths], gt


def _seq3d(np):
    """The 72 seq3d sweeps as (n, 3) arrays, and the ground-truth world poses
    (rotations, translations)."""
    import glob

    from icp_tpu_torch.io import read_ply

    paths = sorted(glob.glob(os.path.join(REPO, SEQ3D, "sweep_*.ply")))
    with open(os.path.join(REPO, SEQ3D, "groundtruth.json")) as f:
        gt = json.load(f)
    return ([read_ply(p) for p in paths], np.asarray(gt["rotations"]),
            np.asarray(gt["translations"]))


def _stack(icp, arrays, capacity, dtype, dev):
    return icp.stack([icp.from_points(a, capacity=capacity, dtype=dtype, device=dev)
                      for a in arrays])


def _coarse_inputs(np):
    """Phase 9f's lanes: scan1's first cloud turned about the origin by
    seeded angles in +-pi (seed 5); the second cloud is every target."""
    from icp_tpu_torch.io import parse_lidar_scan_array

    a, b = (parse_lidar_scan_array(os.path.join(REPO, f"ex_data/scan1/{f}.csv"))
            for f in ("first", "second"))
    angles = np.random.default_rng(5).uniform(-math.pi, math.pi, COARSE_LANES)
    c, s = np.cos(angles), np.sin(angles)
    rots = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    return np.einsum("lij,nj->lni", rots, a), a, b


def _phase9_reference(task: str) -> dict:
    """One group of phase 9's CPU float64 runs of the port (a worker
    process's job); returns numpy arrays.  Clouds keep their own capacity
    (the largest sweep rounded up to 8): results do not depend on padding."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    torch.set_num_threads(2)
    import icp_tpu_torch as icp
    from icp_tpu_torch import mapping, odometry
    from icp_tpu_torch.ops.coarse import coarse_align_2d

    cpu = "cpu"
    t0 = time.perf_counter()
    out = {}
    if task == "chains":
        scans = _stack(icp, _seq1(np)[0], None, None, cpu)
        for mode in CHAIN_MODES:
            traj = odometry.chain_scans(scans, icp.from_method("trimmed", 2),
                                        icp.DriverConfig(**CHAIN_CFG), **_chain_kw(mode))
            out[mode] = traj.poses.translation.numpy()
    elif task == "streams":
        clouds = [icp.from_points(a, device=cpu) for a in _seq1(np)[0][:STREAM_SCANS]]
        method = icp.from_method("trimmed", 2, icp.Config(overlap_rate=0.9))
        for variant in STREAMS:
            res = list(getattr(odometry, variant)(clouds, method, _bench_cfg(icp),
                                                  STREAM_TRANSLATION, STREAM_ANGLE))
            out[variant] = (np.stack([p.translation.numpy() for p, _, _ in res]),
                            [bool(f) for _, f, _ in res])
    elif task in ("scan_to_map", "scan_to_map_f32"):
        sweeps, _ = _seq1(np)
        dtype = torch.float32 if task.endswith("f32") else torch.float64
        for label, name, _, device_map in S2M_RUNS:
            res = list(mapping.scan_to_map_odometry(
                [icp.from_points(a, dtype=dtype, device=cpu) for a in sweeps[:S2M_GATED]],
                icp.from_method(name, 2), icp.DriverConfig(**CHAIN_CFG), voxel_size=VOXEL,
                map_capacity=MAP_CAPACITY, device_map=device_map))
            out[label] = (np.stack([p.translation.double().numpy() for p, _, _ in res]),
                          [bool(f) for _, f, _ in res])
    elif task == "seq3d":
        traj = odometry.chain_scans(_stack(icp, _seq3d(np)[0][:SEQ3D_GATED], None, None, cpu),
                                    icp.from_method("gicp", 3, icp.Config(**GICP_3D)),
                                    icp.DriverConfig(**SEQ3D_CFG))
        out["poses"] = traj.poses.translation.numpy()
    elif task == "coarse2d":
        src_pts, a, b = _coarse_inputs(np)
        src = _stack(icp, list(src_pts), None, None, cpu)
        tgt = icp.stack([icp.from_points(b, capacity=src.capacity, device=cpu)] * COARSE_LANES)
        guess = coarse_align_2d(src, tgt)
        out["angles"] = torch.atan2(guess.rotation[:, 1, 0], guess.rotation[:, 0, 0]).numpy()
        sub = slice(None, None, COARSE_CPU_STRIDE)
        method, cfg = icp.from_method("trimmed", 2), _bench_cfg(icp)
        res, _ = icp.converge(method, icp.PointCloud(src.points[sub], src.count[sub]),
                              icp.PointCloud(tgt.points[sub], tgt.count[sub]),
                              icp.RigidTransform(guess.rotation[sub], guess.translation[sub]), cfg)
        out["translations"] = res.transform.translation.numpy()
        ref, _ = icp.converge(method, icp.from_points(a, device=cpu),
                              icp.from_points(b, device=cpu), icp.identity(2, device=cpu), cfg)
        out["reference"] = ref.transform.translation.numpy()
    else:
        raise ValueError(f"unknown reference task {task!r}")
    out["seconds"] = time.perf_counter() - t0
    return out


def _chain_kw(mode: str) -> dict:
    return {} if mode == "plain" else {mode: True}


@contextlib.contextmanager
def _target_sizes():
    """Count the NN kernel's launches by (K1 or K2, target count M) while the
    block runs; the launch counters themselves are untouched."""
    from icp_tpu_torch.ops import fused_nn

    launch = fused_nn.launch_nn_kernel
    sizes = collections.Counter()

    def counted(query, targets, target_mask, return_coords):
        sizes[f"{'K1' if return_coords else 'K2'} M={targets.shape[-2]}"] += 1
        return launch(query, targets, target_mask, return_coords)

    fused_nn.launch_nn_kernel = counted
    try:
        yield sizes
    finally:
        fused_nn.launch_nn_kernel = launch


def _gate(label: str, got, want) -> float:
    """Max translation deviation of CUDA float32 poses from the CPU float64
    run; fails over POSE_AGREEMENT_TOL_M."""
    import numpy as np

    dt = float(np.linalg.norm(np.asarray(got, dtype=np.float64) - want, axis=-1).max())
    if not dt <= POSE_AGREEMENT_TOL_M:
        raise AssertionError(f"{label}: CUDA f32 vs CPU f64 max |dt| {dt} > "
                             f"{POSE_AGREEMENT_TOL_M} m")
    return dt


def _ms_line(times) -> str:
    return (f"median of {len(times)} {sorted(times)[len(times) // 2] * 1e3:.2f} ms (runs ms "
            f"{', '.join(f'{x * 1e3:.2f}' for x in times)})")


def _front_chains(torch, np, icp, dev, refs) -> dict:
    """Phase 9a: all 120 seq1 sweeps, 119 pairs in one batch at the bucket
    capacity, trimmed, plain / coarse / multiscale."""
    from icp_tpu_torch import eval as ev
    from icp_tpu_torch import geometry, odometry

    sweeps, gt = _seq1(np)
    scans = _stack(icp, sweeps, "bucket", torch.float32, dev)
    c, s = np.cos(gt[:, 2]), np.sin(gt[:, 2])
    gt_poses = icp.RigidTransform(
        torch.tensor(np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)),
        torch.tensor(gt[:, :2]))
    dx, dy = np.diff(gt[:, 0]), np.diff(gt[:, 1])
    truth = np.stack([c[:-1] * dx + s[:-1] * dy, -s[:-1] * dx + c[:-1] * dy], -1)
    method, cfg = icp.from_method("trimmed", 2), icp.DriverConfig(**CHAIN_CFG)
    cpu = refs["chains"].get()
    paths = {}
    for mode in CHAIN_MODES:
        def run():
            traj = odometry.chain_scans(scans, method, cfg, **_chain_kw(mode))
            float(traj.poses.translation.sum())  # waits for the device
            return traj

        traj, times, launches = _timed_runs(run, 3)
        paths[f"seq1 chain {mode}"] = launches
        if launches["K1"] <= 0 or launches["K2"] <= 0:
            raise AssertionError(f"seq1 chain {mode}: not through K1 and K2: {launches}")
        poses = traj.poses.translation.double().cpu().numpy()
        if poses.shape != (len(sweeps), 2) or not np.isfinite(poses).all():
            raise AssertionError(f"seq1 chain {mode}: bad poses {poses.shape}")
        step = np.linalg.norm(geometry.inverse(traj.relative).translation.double().cpu().numpy()
                              - truth, axis=-1)
        ate, rpe = ev.ate(traj.poses, gt_poses), ev.rpe(traj.poses, gt_poses)
        dt = _gate(f"seq1 chain {mode}", poses, cpu[mode])
        iters = traj.registration.iteration_count
        _say("front-chain", f"seq1 {mode} chain, {len(sweeps) - 1} pairs at capacity "
                            f"{scans.capacity}: {(len(sweeps) - 1) / sorted(times)[1]:.2f} "
                            f"pairs/s, {_ms_line(times)}; iterations mean "
                            f"{float(iters.float().mean()):.2f} max {int(iters.max())}; per-step "
                            f"error vs ground truth max {step.max():.4e} median "
                            f"{np.median(step):.4e} m; ATE rmse {ate.rmse:.4e} m, RPE trans rmse "
                            f"{rpe.trans_rmse:.4e} m, rot rmse "
                            f"{math.degrees(rpe.rot_rmse_rad):.4e} deg; launches {launches}; "
                            f"CUDA f32 vs CPU f64 max |dt| {dt:.3e} m (gate "
                            f"{POSE_AGREEMENT_TOL_M})")
        if mode == "plain":
            _say("front-trace", "seq1 plain chain: " + _trace(torch, run))
    return paths


def _front_streams(torch, np, icp, dev, refs) -> dict:
    """Phase 9b: both streams over the first 32 sweeps at capacity 1024."""
    from icp_tpu_torch import odometry

    clouds = [icp.from_points(a, capacity=CAPACITY, dtype=torch.float32, device=dev)
              for a in _seq1(np)[0][:STREAM_SCANS]]
    method = icp.from_method("trimmed", 2, icp.Config(overlap_rate=0.9))

    def stream(variant, scans):
        out = list(getattr(odometry, variant)(scans, method, _bench_cfg(icp),
                                              STREAM_TRANSLATION, STREAM_ANGLE))
        float(out[-1][0].translation.sum())
        return out

    for variant in STREAMS:  # warm-up
        stream(variant, clouds[:4])
    _say("front-trace", "stream_odometry, 8 sweeps: " + _trace(
        torch, lambda: stream(STREAMS[0], clouds[:8])))
    ms, launches, results = {v: [] for v in STREAMS}, {}, {}
    for rep in range(3):  # interleaved repeats
        for variant in STREAMS:
            if rep == 0:
                _reset_launches()
            t0 = time.perf_counter()
            results[variant] = stream(variant, clouds)
            ms[variant].append((time.perf_counter() - t0) / (len(clouds) - 1) * 1e3)
            if rep == 0:
                launches[f"stream {variant}"] = _read_launches()
    cpu = refs["streams"].get()
    for variant in STREAMS:
        out = results[variant]
        flags = [bool(f) for _, f, _ in out]
        if flags != cpu[variant][1]:
            raise AssertionError(f"{variant}: keyframe flags {flags} != CPU f64 {cpu[variant][1]}")
        dt = _gate(variant, np.stack([p.translation.double().cpu().numpy() for p, _, _ in out]),
                   cpu[variant][0])
        med = sorted(ms[variant])[1]
        _say("front-stream", f"{variant}, {len(clouds)} sweeps: {med:.2f} ms/scan (median of 3 "
                             f"interleaved, runs {', '.join(f'{x:.2f}' for x in ms[variant])}); "
                             f"keyframes {sum(flags)}, flags equal the CPU f64 run; launches "
                             f"{launches[f'stream {variant}']}; max |dt| {dt:.3e} m")
    return launches


def _front_scan_to_map(torch, np, icp, dev, refs) -> dict:
    """Phase 9c: scan-to-map over seq1, host and device maps; then the
    64k-map merge of bench.py::run_mapping."""
    from icp_tpu_torch import mapping
    from icp_tpu_torch.utils.metrics import MetricsLogger

    sweeps, gt = _seq1(np)
    c0, s0 = math.cos(gt[0, 2]), math.sin(gt[0, 2])
    truth = (gt[:, :2] - gt[0, :2]) @ np.array([[c0, -s0], [s0, c0]])  # in sweep 0's frame
    cpu64, cpu32 = refs["scan_to_map"].get(), refs["scan_to_map_f32"].get()
    paths = {}
    for label, name, n, device_map in S2M_RUNS:
        clouds = [icp.from_points(a, capacity=CAPACITY, dtype=torch.float32, device=dev)
                  for a in sweeps[:n]]
        method = icp.from_method(name, 2)

        def run(scans, sink=None):
            with MetricsLogger(sink) as log:
                out = list(mapping.scan_to_map_odometry(
                    scans, method, icp.DriverConfig(**CHAIN_CFG), voxel_size=VOXEL,
                    map_capacity=MAP_CAPACITY, metrics=log, device_map=device_map))
            float(out[-1][0].translation.sum())
            return out

        run(clouds[:4])  # warm-up
        sink = io.StringIO()
        _reset_launches()
        with _target_sizes() as sizes:
            t0 = time.perf_counter()
            out = run(clouds, sink)
            total = time.perf_counter() - t0
        paths[f"scan-to-map {label}"] = launches = _read_launches()
        if sum(launches.values()) <= 0:
            raise AssertionError(f"scan-to-map {label}: no NN kernel launched")
        flags = [bool(f) for _, f, _ in out]
        last = json.loads(sink.getvalue().splitlines()[-1])
        poses = np.stack([p.translation.double().cpu().numpy() for p, _, _ in out])
        err = np.linalg.norm(poses - truth[:n], axis=-1)
        ref64, ref32 = cpu64[label][0], cpu32[label][0]
        dt = float(np.linalg.norm(poses[:S2M_GATED] - ref64, axis=-1).max())
        dt32 = float(np.linalg.norm(ref32 - ref64, axis=-1).max())
        if dt > POSE_AGREEMENT_TOL_M and dt32 <= POSE_AGREEMENT_TOL_M:
            raise AssertionError(f"scan-to-map {label}: CUDA f32 misses the gate ({dt} m) where "
                                 f"CPU f32 meets it ({dt32} m)")
        verdict = ("met" if dt <= POSE_AGREEMENT_TOL_M else
                   "missed, and the CPU float32 run misses it too: float32's")
        _say("front-map", f"{label}, {n} sweeps (scan capacity {CAPACITY}, map "
                          f"{MAP_CAPACITY}, voxel {VOXEL}): {total / (n - 1) * 1e3:.2f} ms/scan "
                          f"(one pass, metrics on), keyframes {sum(flags)}, map points after "
                          f"the last scan {last['map_points']}, launches {launches}, by target "
                          f"count {dict(sizes)}; error vs ground truth max {err.max():.4f} "
                          f"mean {err.mean():.4f} m (first above 0.1 m at sweep "
                          f"{int(np.argmax(err > 0.1)) if (err > 0.1).any() else None}); first "
                          f"{S2M_GATED} sweeps: flags equal the CPU f64 run "
                          f"{flags[:S2M_GATED] == cpu64[label][1]}, CUDA f32 vs CPU f64 max |dt| "
                          f"{dt:.3e} m, CPU f32 vs CPU f64 {dt32:.3e} m: gate "
                          f"{POSE_AGREEMENT_TOL_M} {verdict}")
    _front_merge(torch, np, icp, dev)
    return paths


def _front_merge(torch, np, icp, dev) -> None:
    """Phase 9c, merge: one keyframe merge of a 4,096-point scan into a full
    65,536-point map (seed 11, voxel 0.2), on the card against the host
    ``LocalMap`` (with its copy of the map to the host); both trim toward
    the scan's centroid."""
    from icp_tpu_torch import mapping

    rng = np.random.default_rng(11)
    map_np = rng.uniform(-40, 40, (MERGE_MAP, 3)).astype(np.float32)
    scan_np = rng.uniform(-5, 5, (MERGE_SCAN, 3)).astype(np.float32)
    map_pts, scan_pts = (torch.tensor(x, device=dev) for x in (map_np, scan_np))
    count = torch.tensor(MERGE_MAP, dtype=torch.int32, device=dev)
    mask = torch.ones(MERGE_SCAN, dtype=torch.bool, device=dev)
    center = torch.tensor(scan_np.mean(axis=0), device=dev)

    def merge():
        out, k = mapping.merge_map_device(map_pts, count, scan_pts, mask, MERGE_VOXEL,
                                          MERGE_MAP, center)
        return out, int(k)

    merge()
    dev_times = []
    for _ in range(10):
        t0 = time.perf_counter()
        out, k = merge()
        dev_times.append(time.perf_counter() - t0)
    host_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        host = mapping.LocalMap(MERGE_VOXEL, MERGE_MAP, map_pts.cpu().numpy()).merged_with(
            scan_pts.cpu().numpy())
        host_times.append(time.perf_counter() - t0)
    got = out[:k].cpu().numpy()

    def canon(a):
        return a[np.lexsort(a.T[::-1])]

    if k != len(host.points):
        raise AssertionError(f"map merge: device count {k} != host {len(host.points)}")
    diff = float(np.abs(canon(got) - canon(host.points)).max())
    if not diff <= 1e-5:
        raise AssertionError(f"map merge: device and host points differ as sets by {diff}")
    _say("front-merge", f"{MERGE_MAP}-point map + {MERGE_SCAN}-point scan, voxel {MERGE_VOXEL}: "
                        f"device {_ms_line(dev_times)}, host (incl. the map's copy to the host) "
                        f"{_ms_line(host_times)}; {k} cells both, equal as sets (max |diff| "
                        f"{diff:.2e})")


def _front_server(torch, np, icp, dev) -> dict:
    """Phase 9d: bench.py::run_serving on the card; every served pose against
    a direct batched converge of the same pair (batches of 64)."""
    from icp_tpu_torch.serve import BatchingRegistrar

    a_pts, b_pts = (icp.io.parse_lidar_scan_array(os.path.join(REPO, f"ex_data/scan1/{f}.csv"))
                    for f in ("first", "second"))
    rng = np.random.default_rng(3)
    sources, results = [], []

    def perturbed():
        ang = rng.uniform(-0.05, 0.05)
        c, s = np.cos(ang), np.sin(ang)
        src = a_pts @ np.array([[c, -s], [s, c]], dtype=np.float32) + rng.uniform(
            -0.2, 0.2, 2).astype(np.float32)
        sources.append(src)
        return src

    method = icp.from_method("trimmed", 2, icp.Config(overlap_rate=0.9))
    cfg = _bench_cfg(icp)
    with BatchingRegistrar(method, cfg, capacity=CAPACITY, max_batch_size=SERVE_BATCH,
                           max_delay=SERVE_DELAY, device=dev) as reg:
        results.append(reg.register(perturbed(), b_pts))  # warm-up
        lats = []
        for _ in range(20):  # low load: one client, blocking
            t0 = time.perf_counter()
            results.append(reg.register(perturbed(), b_pts))
            lats.append(time.perf_counter() - t0)
        tputs, p50s, p99s = [], [], []
        for rep in range(3):  # bursts
            if rep == 0:
                _reset_launches()
            t0 = time.perf_counter()
            submits, futures = [], []
            for _ in range(SERVE_BURST):
                submits.append(time.perf_counter())
                futures.append(reg.submit(perturbed(), b_pts))
            done = []
            for t_sub, fut in zip(submits, futures):
                results.append(fut.result(timeout=600))
                done.append(time.perf_counter() - t_sub)
            tputs.append(SERVE_BURST / (time.perf_counter() - t0))
            if rep == 0:
                launches = _read_launches()
            p50s.append(float(np.percentile(done, 50)) * 1e3)
            p99s.append(float(np.percentile(done, 99)) * 1e3)
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise AssertionError(f"server: a burst did not launch K1 and K2: {launches}")
    tgt = icp.stack([icp.from_points(b_pts, capacity=CAPACITY, dtype=torch.float32,
                                     device=dev)] * SERVE_BATCH)
    guess = icp.identity(2, (SERVE_BATCH,), dtype=torch.float32, device=dev)
    worst = 0.0
    for i in range(0, len(sources), SERVE_BATCH):
        chunk = sources[i:i + SERVE_BATCH]
        src = icp.stack([icp.from_points(p, capacity=CAPACITY, dtype=torch.float32, device=dev)
                         for p in chunk + chunk[:1] * (SERVE_BATCH - len(chunk))])
        direct, _ = icp.converge(method, src, tgt, guess, cfg)
        want = direct.transform.translation[: len(chunk)].cpu().numpy()
        got = np.stack([r.translation for r in results[i:i + SERVE_BATCH]])
        worst = max(worst, float(np.linalg.norm(got - want, axis=-1).max()))
    if not worst <= SERVE_TOL_M:
        raise AssertionError(f"server: a served pose differs from the direct converge by {worst}")
    _say("front-server", f"scan1 trimmed, capacity {CAPACITY}, max batch {SERVE_BATCH}, max delay "
                         f"{SERVE_DELAY} s: low-load p50 {np.percentile(lats, 50) * 1e3:.2f} ms "
                         f"(20 blocking requests); bursts of {SERVE_BURST} x 3: p50 "
                         f"{np.median(p50s):.2f} ms ({', '.join(f'{x:.2f}' for x in p50s)}), p99 "
                         f"{np.median(p99s):.2f} ms ({', '.join(f'{x:.2f}' for x in p99s)}), "
                         f"{np.median(tputs):.2f} pairs/s ({', '.join(f'{x:.2f}' for x in tputs)})"
                         f"; first burst's launches {launches}; {len(results)} results, none "
                         f"raised, max |dt| vs direct converge {worst:.3e} m (gate {SERVE_TOL_M})")
    return {"server burst (first of 3)": launches}


def _front_seq3d(torch, np, icp, dev, refs) -> dict:
    """Phase 9e: the 72 seq3d sweeps, gicp 3D chain with the per-scan
    precompute cache; then coarse_align_3d on the 71 pairs."""
    from icp_tpu_torch import odometry
    from icp_tpu_torch.ops.coarse import coarse_align_3d

    sweeps, gt_rot, gt_trans = _seq3d(np)
    scans = _stack(icp, sweeps, "bucket", torch.float32, dev)
    method = icp.from_method("gicp", 3, icp.Config(**GICP_3D))
    cfg = icp.DriverConfig(**SEQ3D_CFG)

    def run():
        traj = odometry.chain_scans(scans, method, cfg)
        float(traj.poses.translation.sum())
        return traj

    traj, times, launches = _timed_runs(run, 3)
    if launches["K2"] <= 0:
        raise AssertionError(f"seq3d gicp chain did not launch K2: {launches}")
    poses = traj.poses.translation.double().cpu().numpy()
    truth_end = gt_rot[0].T @ (gt_trans[-1] - gt_trans[0])
    dt = _gate("seq3d gicp chain", poses[:SEQ3D_GATED], refs["seq3d"].get()["poses"])
    iters = traj.registration.iteration_count
    _say("front-seq3d", f"seq3d gicp 3D chain, {len(sweeps) - 1} pairs at capacity "
                        f"{scans.capacity}: {_ms_line(times)} per call, iterations mean "
                        f"{float(iters.float().mean()):.2f} max {int(iters.max())}, end-pose "
                        f"error vs ground truth {np.linalg.norm(poses[-1] - truth_end):.4e} m, "
                        f"launches {launches}; first {SEQ3D_GATED} sweeps: CUDA f32 vs CPU "
                        f"f64 max |dt| {dt:.3e} m")
    sources = icp.PointCloud(scans.points[:-1], scans.count[:-1])
    targets = icp.PointCloud(scans.points[1:], scans.count[1:])

    def coarse():
        guess = coarse_align_3d(sources, targets)
        float(guess.translation.sum())
        return guess

    guess, ctimes, claunches = _timed_runs(coarse, 5)
    if claunches["K2"] != 1 or not torch.isfinite(guess.rotation).all():
        raise AssertionError(f"coarse_align_3d: launches {claunches}, finite "
                             f"{bool(torch.isfinite(guess.rotation).all())}")
    _say("front-seq3d", f"coarse_align_3d on the {len(sweeps) - 1} pairs: {_ms_line(ctimes)}, "
                        f"launches {claunches} (the 4 candidates of every pair in one K2 "
                        f"launch)")
    return {"seq3d gicp chain": launches, "seq3d coarse_align_3d": claunches}


def _front_coarse2d(torch, np, icp, dev, refs) -> dict:
    """Phase 9f: coarse_align_2d then trimmed, scan1, 1,024 lanes turned by
    seeded angles in +-pi."""
    from icp_tpu_torch import convert
    from icp_tpu_torch.ops.coarse import coarse_align_2d

    src_pts, a, b = _coarse_inputs(np)
    counts = np.full(COARSE_LANES, len(a), dtype=np.int32)
    padded = np.zeros((COARSE_LANES, CAPACITY, 2))
    padded[:, : len(a)] = src_pts
    src = convert.cloud_from_numpy(padded, counts, dtype=torch.float32, device=dev)
    tgt = icp.stack([icp.from_points(b, capacity=CAPACITY, dtype=torch.float32,
                                     device=dev)] * COARSE_LANES)
    method, cfg = icp.from_method("trimmed", 2), _bench_cfg(icp)

    def run():
        guess = coarse_align_2d(src, tgt)
        out, _ = icp.converge(method, src, tgt, guess, cfg)
        float(out.cost.sum())
        return guess, out

    (guess, out), times, launches = _timed_runs(run, 3)
    ref, _ = icp.converge(method, icp.from_points(a, dtype=torch.float32, device=dev),
                          icp.from_points(b, dtype=torch.float32, device=dev),
                          icp.identity(2, dtype=torch.float32, device=dev), cfg)
    near = (torch.linalg.vector_norm(out.transform.translation - ref.transform.translation,
                                     dim=-1) < NDT_CONVERGED_M).cpu().numpy()
    cpu = refs["coarse2d"].get()
    cpu_near = np.linalg.norm(cpu["translations"] - cpu["reference"], axis=-1) < NDT_CONVERGED_M
    angles = torch.atan2(guess.rotation[:, 1, 0], guess.rotation[:, 0, 0]).double().cpu().numpy()
    bins_off = np.abs(np.angle(np.exp(1j * (angles - cpu["angles"])))) / HIST_BIN
    if not bins_off.max() <= 1.0:
        raise AssertionError(f"coarse 2D: a card guess is {bins_off.max():.3f} bins from the CPU's")
    _say("front-coarse2d", f"scan1, {COARSE_LANES} lanes turned by angles in +-pi: coarse + "
                           f"trimmed {COARSE_LANES / sorted(times)[1]:.2f} pairs/s, "
                           f"{_ms_line(times)}; converged lanes (within {NDT_CONVERGED_M} m of "
                           f"the identity-seeded trimmed pose) card {int(near.sum())}/"
                           f"{COARSE_LANES}; on every {COARSE_CPU_STRIDE}th lane card "
                           f"{int(near[::COARSE_CPU_STRIDE].sum())}, CPU f64 "
                           f"{int(cpu_near.sum())} of {len(cpu_near)}; card guesses vs CPU f64: "
                           f"max {bins_off.max():.4f} bins, {int((bins_off > 1e-3).sum())} lanes "
                           f"off by more than 1e-3 bin; launches {launches}")
    return {"coarse 2d + trimmed": launches}


def _phase_front_end(torch, np, icp, dev, refs) -> dict:
    """Phase 9: the front end; returns the launches of each path."""
    paths = _front_chains(torch, np, icp, dev, refs)
    paths.update(_front_streams(torch, np, icp, dev, refs))
    paths.update(_front_scan_to_map(torch, np, icp, dev, refs))
    paths.update(_front_server(torch, np, icp, dev))
    paths.update(_front_seq3d(torch, np, icp, dev, refs))
    paths.update(_front_coarse2d(torch, np, icp, dev, refs))
    _say("front-references", "CPU runs in worker processes, seconds: " + ", ".join(
        f"{task} {refs[task].get()['seconds']:.1f}" for task in REFERENCE_TASKS))
    torch.cuda.empty_cache()
    return paths


# Phase 10: the pose-graph back end, after tests/test_manhattan_g2o.py (the
# three bundled graphs at the JAX tests' budgets and bounds),
# bench.py::run_pose_graph (:739-799, the 10k-node / 30k-edge graph), the
# verify recipes on m600 (gnc_gm + pcg, two-pass welsch, one outlier-protocol
# cell) and offline loop closure over ex_data/seq2loop (the kernel path).
MANHATTAN = "ex_data/manhattan"
# (name, GN iterations, PCG steps, chi² bound per edge: 3·dof in 2D, 6·dof in 3D)
G2O_CELLS = (("m600", 30, 50, 9), ("m3500", 30, 50, 9), ("sphere2500", 40, 60, 36))
G2O_DROP = {"m600": 1e-3, "m3500": 1e-4, "sphere2500": 1e-3}
SYNTH_NODES, SYNTH_LOOPS, SYNTH_GN, SYNTH_CG = 10_000, 20_000, 5, 50
SEQ2LOOP = "ex_data/seq2loop"
LOOP_RADIUS, LOOP_MIN_SEP, LOOP_WEIGHT, CLOSURE_CPU_STRIDE = 2.0, 10, 100.0, 8
PROTOCOL_CELL = dict(rates=(0.2,), modes=("random",), kernels=("welsch",), solver="pcg",
                     seed=3, scale_passes=2)


def _seq2loop(np):
    """The 240 seq2loop sweeps as (n, 2) arrays, the ground-truth poses
    (x, y, theta), and the sweeps' paths."""
    import glob

    from icp_tpu_torch.io import parse_sweep_conf, sweep_to_points

    paths = sorted(glob.glob(os.path.join(REPO, SEQ2LOOP, "sweep_*.conf")))
    with open(os.path.join(REPO, SEQ2LOOP, "groundtruth.json")) as f:
        gt = np.asarray(json.load(f)["poses"])
    return [sweep_to_points(parse_sweep_conf(p)) for p in paths], gt, paths


def _gt_transform(icp, torch, np, gt):
    c, s = np.cos(gt[:, 2]), np.sin(gt[:, 2])
    return icp.RigidTransform(
        torch.tensor(np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)),
        torch.tensor(gt[:, :2]))


def _closure_case(torch, np, icp, dev):
    """Phase 3's input at the closure batch's shape: seq2loop's candidate
    pairs on the ground-truth trajectory (the radius and separation of
    phase 10d), each source moved by its ground-truth relative pose."""
    from icp_tpu_torch import geometry, pose_graph

    sweeps, gt, _ = _seq2loop(np)
    scans = _stack(icp, sweeps, CAPACITY, torch.float32, dev)
    truth = _gt_transform(icp, torch, np, gt)
    truth = icp.RigidTransform(truth.rotation.float().to(dev), truth.translation.float().to(dev))
    cands = pose_graph.find_loop_candidates(truth, LOOP_RADIUS, LOOP_MIN_SEP).long()
    i, j = cands[:, 0], cands[:, 1]
    seed = geometry.compose(geometry.inverse(pose_graph._gather(truth, i)),
                            pose_graph._gather(truth, j))
    q = geometry.apply(seed, scans.points[j]).contiguous()
    return (f"seq2loop closure batch ({len(cands)}, {CAPACITY}, {CAPACITY}, 2) f32", None, q,
            scans.points[i].contiguous(), scans.mask[i].contiguous())


def _phase10_reference(task: str, payload=None) -> dict:
    """One group of phase 10's CPU runs of the port (a worker process's
    job), float64 and float32; returns numpy arrays."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    torch.set_num_threads(2)
    import icp_tpu_torch as icp
    from icp_tpu_torch import convert, pose_graph

    t0 = time.perf_counter()
    out = {}
    if task == "g2o":
        name, dtype = payload
        _, iters, cg, _ = next(cell for cell in G2O_CELLS if cell[0] == name)
        graph = icp.io.read_g2o(os.path.join(REPO, MANHATTAN, f"{name}.g2o"),
                                dtype=getattr(torch, dtype), device="cpu")
        opt, costs = pose_graph.optimize(graph, iterations=iters, solver="pcg",
                                         cg_iterations=cg)
        out["translation"], out["costs"] = (opt.poses.translation.double().numpy(),
                                            costs.double().numpy())
    elif task == "seq2loop_graph":
        fields, n_loop, dtype = payload
        graph = convert.pose_graph_from_numpy(fields, dtype=getattr(torch, dtype), device="cpu")
        mask = torch.arange(graph.num_edges) >= graph.num_edges - n_loop
        opt, _, scale, _ = pose_graph.robust_solve(graph, robust_edges=mask)
        out["translation"], out["scale"] = opt.poses.translation.double().numpy(), scale
    elif task == "seq2loop_closures":
        rotation, translation, cands, dtype = payload
        scans = _stack(icp, _seq2loop(np)[0], CAPACITY, getattr(torch, dtype), "cpu")
        poses = convert.transform_from_numpy(rotation, translation, dtype=getattr(torch, dtype),
                                             device="cpu")
        _, meas, _ = pose_graph.register_loop_closures(
            scans, poses, cands, icp.from_method("trimmed", 2), icp.DriverConfig(**CHAIN_CFG))
        out["translation"] = meas.translation.double().numpy()
    else:
        raise ValueError(f"unknown reference task {task!r}")
    out["seconds"] = time.perf_counter() - t0
    return out


def _float32_gate(label: str, got, want64, want32=None, float32_rows=None) -> str:
    """Max |dt| of the card's float32 translations from CPU float64.  Over
    the gate a row passes only where CPU float32 misses by as much too (PR
    4's rule: then it is float32's, not the card's); ``float32_rows(rows)``
    computes the CPU float32 rows on demand when ``want32`` is not given."""
    import numpy as np

    dev = np.linalg.norm(np.asarray(got, dtype=np.float64) - want64, axis=-1)
    over = np.flatnonzero(dev > POSE_AGREEMENT_TOL_M)
    line = (f"CUDA f32 vs CPU f64 max |dt| {dev.max():.4e} m (gate {POSE_AGREEMENT_TOL_M}), "
            f"{len(over)} of {len(dev)} over it")
    if want32 is None and len(over):
        want32 = np.zeros_like(want64)
        want32[over] = float32_rows(over)
    if want32 is not None:
        dev32 = np.linalg.norm(want32[over] - want64[over], axis=-1)
        if (dev32 <= POSE_AGREEMENT_TOL_M).any():
            raise AssertionError(f"{label}: {int((dev32 <= POSE_AGREEMENT_TOL_M).sum())} rows "
                                 f"over the gate from CPU f64 where CPU f32 is within it "
                                 f"(card max |dt| {dev.max():.4e})")
        if len(over):
            line += f", each also over it in CPU f32 (min {dev32.min():.4e}: float32's)"
    return line


def _solve_profile(torch, label: str, solve, iterations: int, times=None) -> str:
    """ms per GN iteration (the median of 3 timed solves after a warm-up;
    ``times`` if they were taken already), kernels per GN iteration (a
    3-iteration solve's count less a 2-iteration one's: the profiler's event
    lists of whole solves run to 10^5 kernels), and the traced device busy
    share of a 3-iteration solve."""
    if times is None:
        _, times, _ = _timed_runs(lambda: solve(iterations), 3)
    per_gn = sorted(times)[1] / iterations * 1e3
    kernels = _kernel_count(torch, lambda: solve(3)) - _kernel_count(torch, lambda: solve(2))
    trace = _trace(torch, lambda: solve(3)).splitlines()[0]
    return (f"{label}: {per_gn:.3f} ms per GN iteration (median of 3 solves: "
            f"{', '.join(f'{x * 1e3:.2f}' for x in times)} ms), {kernels} kernels per GN "
            f"iteration; a traced 3-iteration solve: {trace}")


def _back_end_g2o(torch, np, icp, dev, refs) -> None:
    """Phase 10a: read_g2o -> optimize(pcg) on the three bundled graphs."""
    from icp_tpu_torch import pose_graph

    for name, iters, cg, bound in G2O_CELLS:
        graph = icp.io.read_g2o(os.path.join(REPO, MANHATTAN, f"{name}.g2o"), device=dev)

        def run(iterations=iters):
            opt, costs = pose_graph.optimize(graph, iterations=iterations, solver="pcg",
                                             cg_iterations=cg)
            return opt, costs.double().cpu().numpy()

        # A warm-up and 3 timed solves; the first and the last are compared.
        runs, times = [run()], []
        for _ in range(3):
            t0 = time.perf_counter()
            runs.append(run())
            times.append(time.perf_counter() - t0)
        (opt, costs), (opt2, _) = runs[0], runs[-1]
        t = opt.poses.translation.double().cpu().numpy()
        repeat = float(np.abs(t - opt2.poses.translation.double().cpu().numpy()).max())
        chi0, chi = costs[0], costs[-1]
        if not np.isfinite(t).all():
            raise AssertionError(f"{name}: non-finite poses")
        drop_ok = chi < G2O_DROP[name] * chi0 and chi < bound * graph.num_edges
        if name == "sphere2500":
            r = np.linalg.norm(t, axis=-1)
            world = f"radii {r.min():.3f}-{r.max():.3f} (24-26)"
            world_ok = 24.0 < r.min() and r.max() < 26.0
        else:
            world = f"max |t| {np.abs(t).max():.3f} ({20 if name == 'm600' else 45})"
            world_ok = np.abs(t).max() < (20 if name == "m600" else 45)
        ref64, ref32 = (refs[f"g2o {name} {dtype}"].get() for dtype in ("float64", "float32"))
        (t64, c64), (t32, c32) = ((r["translation"], r["costs"]) for r in (ref64, ref32))
        gates = (f"chi2 {chi0:.6g} -> {chi:.6g} (bounds < {G2O_DROP[name]:g} x start, < "
                 f"{bound} x {graph.num_edges}; CPU f64 {c64[-1]:.6g}, CPU f32 {c32[-1]:.6g}), "
                 f"{world}")
        if not (drop_ok and world_ok):
            if c32[-1] < G2O_DROP[name] * c32[0] and c32[-1] < bound * graph.num_edges:
                raise AssertionError(f"{name}: a gate missed where CPU f32 meets it: {gates}")
            gates += "; MISSED, and CPU f32 misses too (float32's)"
        _say("back-g2o", f"{name} ({graph.num_nodes} nodes, {graph.num_edges} edges), pcg "
                         f"{iters} x {cg}: {gates}; {_float32_gate(name, t, t64, t32)}; the first "
                         f"and the last card run differ by max |dt| {repeat:.3e} m (index_add_ "
                         "order)")
        _say("back-g2o", _solve_profile(torch, name, run, iters, times))
    torch.cuda.empty_cache()


def _synthetic_graph(torch, np, icp, dev):
    """bench.py::run_pose_graph's graph on the card, float32: seed 7, 10,000
    nodes integrating noisy odometry, 20,000 closures of span 2-49 measuring
    the ground truth, loop weight 10."""
    from icp_tpu_torch import geometry, lie, odometry, pose_graph

    rng = np.random.default_rng(7)
    twists = rng.uniform(-0.2, 0.2, (SYNTH_NODES - 1, 3))
    noisy = torch.tensor(twists + rng.normal(0, 0.01, twists.shape), dtype=torch.float32,
                         device=dev)
    rel = lie.se2_exp(noisy)
    ident = icp.identity(2, dtype=torch.float32, device=dev)
    poses0 = odometry.compose_chain(geometry.inverse(rel), ident)
    gt = odometry.compose_chain(geometry.inverse(lie.se2_exp(
        torch.tensor(twists, dtype=torch.float32, device=dev))), ident)
    li = rng.integers(0, SYNTH_NODES - 2, SYNTH_LOOPS)
    lj = np.minimum(li + rng.integers(2, 50, SYNTH_LOOPS), SYNTH_NODES - 1)
    ti, tj = torch.tensor(li, device=dev), torch.tensor(lj, device=dev)
    loop_meas = icp.RigidTransform(
        gt.rotation[ti].transpose(-1, -2) @ gt.rotation[tj],
        torch.einsum("eji,ej->ei", gt.rotation[ti], gt.translation[tj] - gt.translation[ti]))
    return pose_graph.graph_from_trajectory(
        poses0, rel, loop_edges=torch.tensor(np.stack([li, lj], -1), dtype=torch.int32,
                                             device=dev),
        loop_measurements=loop_meas, loop_weight=10.0)


def _back_end_synthetic(torch, np, icp, dev) -> None:
    """Phase 10b: the 10k-node / 30k-edge synthetic SE(2) graph, 5 GN x 50 PCG."""
    from icp_tpu_torch import pose_graph

    graph = _synthetic_graph(torch, np, icp, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run(iterations=SYNTH_GN):
        opt, costs = pose_graph.optimize(graph, iterations=iterations, solver="pcg",
                                         cg_iterations=SYNTH_CG)
        return opt, costs.double().cpu().numpy()

    opt, costs = run()
    if not (np.isfinite(costs).all() and costs[-1] < costs[0]):
        raise AssertionError(f"synthetic 10k graph: costs {costs}")
    peak = torch.cuda.max_memory_allocated() / 2**20
    _say("back-synthetic", f"{graph.num_nodes} nodes, {graph.num_edges} edges, pcg {SYNTH_GN} x "
                           f"{SYNTH_CG}: cost {costs[0]:.6g} -> {costs[-1]:.6g} (drop "
                           f"{costs[0] / max(costs[-1], 1e-30):.2f}x), peak device memory "
                           f"{peak:.1f} MiB")
    _say("back-synthetic", _solve_profile(torch, "10k / 30k", run, SYNTH_GN))
    del graph, opt
    torch.cuda.empty_cache()


def _back_end_robust(torch, np, icp, dev) -> None:
    """Phase 10c: robust solves on m600."""
    from icp_tpu_torch import pose_graph, robustness

    graph = icp.io.read_g2o(os.path.join(REPO, MANHATTAN, "m600.g2o"), device=dev)
    mask = robustness.closure_mask(graph, 2)
    t0 = time.perf_counter()
    scale = pose_graph.auto_robust_scale(graph, iterations=30, solver="pcg", robust_edges=mask)
    opt, costs = pose_graph.optimize(graph, iterations=30, solver="pcg", robust="gnc_gm",
                                     robust_scale=scale, robust_edges=mask)
    chi = costs.double().cpu().numpy()
    gnc_s = time.perf_counter() - t0
    if not (1.5 < float(scale) < 2.1 and chi[-1] < 2e3 and np.isfinite(chi).all()):
        raise AssertionError(f"m600 gnc_gm: scale {float(scale)}, chi2 {chi[0]} -> {chi[-1]}")
    _say("back-robust", f"m600 gnc_gm pcg, auto scale on the loop-like edges: scale "
                        f"{float(scale):.4f} (verify recipe ~1.79), chi2 {chi[0]:.6g} -> "
                        f"{chi[-1]:.6g} (~1.3e3), {gnc_s * 1e3:.1f} ms with the L2 pre-solve")
    t0 = time.perf_counter()
    two, _, s2, w2 = pose_graph.robust_solve(graph, kernel="welsch", robust_edges=mask,
                                             solver="pcg")
    two_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused, _, sf, wf = pose_graph.robust_solve_fused(graph, mask, kernel="welsch", solver="pcg")
    float(sf)
    fused_s = time.perf_counter() - t0
    dt = float(torch.linalg.vector_norm(two.poses.translation - fused.poses.translation,
                                        dim=-1).max())
    dw = float((w2 - wf).abs().max())
    if not (abs(float(sf) - s2) <= 1e-4 * s2 and dt <= POSE_AGREEMENT_TOL_M):
        raise AssertionError(f"m600 fused vs host two-pass: scale {float(sf)} vs {s2}, |dt| {dt}")
    _say("back-robust", f"m600 two-pass welsch: robust_solve scale {s2:.6g}, {two_s * 1e3:.1f} ms; "
                        f"robust_solve_fused scale {float(sf):.6g}, {fused_s * 1e3:.1f} ms; fused "
                        f"vs host max |dt| {dt:.3e} m, max |dw| {dw:.3e}")
    t0 = time.perf_counter()
    rec = robustness.run_protocol(graph, **PROTOCOL_CELL)[0]
    if not (rec["recall"] == 1.0 and rec["inliers_kept"] == 1.0):
        raise AssertionError(f"m600 protocol cell: {rec}")
    _say("back-robust", f"m600 protocol cell (random, rate 0.2, welsch, 2 passes, seed 3): "
                        f"recall {rec['recall']}, inliers kept {rec['inliers_kept']}, precision "
                        f"{rec['precision']:.4f}, {rec['n_injected']} injected, scale "
                        f"{rec['scale']:.4f}, ATE vs the clean oracle "
                        f"{rec['ate_vs_oracle']:.4e} m, {(time.perf_counter() - t0):.2f} s")
    torch.cuda.empty_cache()


def _back_end_seq2loop(torch, np, icp, dev, pool):
    """Phase 10d: offline loop closure over seq2loop, the kernel path.  A
    generator: its first step runs the card's part and yields the launches
    of its paths, K1/K2's deviation from their plain version on the closure
    batch and that case's label; its second holds the card against the CPU
    runs that the first queued."""
    from icp_tpu_torch import convert, geometry, odometry, pose_graph
    from icp_tpu_torch import eval as ev
    from icp_tpu_torch.ops import fused_nn, nn, pallas_nn

    sweeps, gt, paths_conf = _seq2loop(np)
    truth = _gt_transform(icp, torch, np, gt)
    method, cfg = icp.from_method("trimmed", 2), icp.DriverConfig(**CHAIN_CFG)
    paths, stage_ms = {}, {}

    def stage(name, fn):
        _reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stage_ms[name] = (time.perf_counter() - t0) * 1e3
        paths[f"seq2loop {name}"] = _read_launches()
        return out

    scans = stage("parse", lambda: icp.stack([icp.io.parse_sweep(
        path, capacity=CAPACITY, dtype=torch.float32, device=dev) for path in paths_conf]))
    traj = stage("chain", lambda: odometry.chain_scans(scans, method, cfg))
    cands = stage("candidates", lambda: pose_graph.find_loop_candidates(
        traj.poses, LOOP_RADIUS, LOOP_MIN_SEP))
    edges, meas, costs = stage("closure batch", lambda: pose_graph.register_loop_closures(
        scans, traj.poses, cands, method, cfg))
    # The CPU runs, in the worker pool while the card goes on: every 8th
    # closure from the card's own seeds (split over the workers), and below
    # the card's own graph; float64, and float32 where a row misses the gate.
    rot64, trans64 = (x.double().cpu().numpy() for x in (traj.poses.rotation,
                                                          traj.poses.translation))
    sub = cands[::CLOSURE_CPU_STRIDE].cpu().numpy()

    def closures_cpu(rows, dtype, parts):
        return [pool.apply_async(_phase10_reference, ("seq2loop_closures", (
            rot64, trans64, sub[rows][k::parts], dtype))) for k in range(parts)]

    closures64 = closures_cpu(np.arange(len(sub)), "float64", REFERENCE_WORKERS)
    n_loop = len(edges)
    graph = stage("graph", lambda: pose_graph.graph_from_trajectory(
        traj.poses, geometry.inverse(traj.relative), loop_edges=edges, loop_measurements=meas,
        loop_weight=LOOP_WEIGHT))
    fields = convert.pose_graph_to_numpy(graph)
    graph64 = pool.apply_async(_phase10_reference, ("seq2loop_graph", (fields, n_loop,
                                                                       "float64")))
    mask = torch.arange(graph.num_edges, device=dev) >= graph.num_edges - n_loop
    opt, _, scale, w = stage("robust solve", lambda: pose_graph.robust_solve(
        graph, kernel="welsch", robust_edges=mask, scale_passes=2))
    for name in ("chain", "closure batch"):
        if min(paths[f"seq2loop {name}"].values()) <= 0:
            raise AssertionError(f"seq2loop {name} did not launch K1 and K2: {paths}")
    kept = int((w[-n_loop:] >= 0.5).sum())
    lines = []
    for label, poses in (("odometry chain", traj.poses), ("after the solve", opt.poses)):
        ate, rpe = ev.ate(poses, truth), ev.rpe(poses, truth)
        lines.append(f"{label}: ATE rmse {ate.rmse:.4e} m, RPE trans rmse {rpe.trans_rmse:.4e} m "
                     f"rot rmse {math.degrees(rpe.rot_rmse_rad):.4e} deg")
    iters = traj.registration.iteration_count
    _say("back-seq2loop", f"{len(sweeps)} sweeps at capacity {CAPACITY}, trimmed to 1e-6; "
                          f"chain iterations mean {float(iters.float().mean()):.2f} max "
                          f"{int(iters.max())}; {len(cands)} candidates (radius {LOOP_RADIUS}, "
                          f"separation >= {LOOP_MIN_SEP}), {n_loop} registered in one batch "
                          f"(costs median {float(costs.median()):.4g}, max "
                          f"{float(costs.max()):.4g}), {kept} kept by the two-pass welsch "
                          f"solve (weight >= 0.5; scale {scale:.4g}); " + "; ".join(lines))
    _say("back-seq2loop", "stages: " + ", ".join(
        f"{name} {ms:.1f} ms {paths[f'seq2loop {name}']}" for name, ms in stage_ms.items())
        + "; launches are counted over each stage")
    # The closure batch's first iterate through the kernel and its plain version.
    i, j = edges[:, 0].long(), edges[:, 1].long()
    seed = geometry.compose(geometry.inverse(pose_graph._gather(traj.poses, i)),
                            pose_graph._gather(traj.poses, j))
    q = geometry.apply(seed, scans.points[j]).contiguous()
    t, m = scans.points[i].contiguous(), scans.mask[i].contiguous()
    err = _compare(torch, fused_nn.fused_nearest_neighbors(q, t, m, return_coords=True),
                   fused_nn.plain_fused_nearest_neighbors(q, t, m, return_coords=True),
                   "K1 seq2loop closure batch")
    err = max(err, _compare(torch, pallas_nn.nearest_neighbors_pallas(q, t, m),
                            nn.nearest_neighbors(q, t, m), "K2 seq2loop closure batch"))
    label = f"seq2loop closure batch as run ({tuple(q.shape[:2]) + tuple(t.shape[1:])}) f32"
    _say("kernel", f"{label}: K1 and K2 exact (idx, coords, sq bits)")
    del q, t, m, scans, traj, graph
    torch.cuda.empty_cache()
    # The CPU runs end while the card runs phases 10a-c; the check follows.
    yield ({k: v for k, v in paths.items() if k.endswith(("chain", "closure batch", "solve"))},
           err, label)

    def interleave(parts):
        """Rows of the CPU runs split k::n over the workers, back in order."""
        rows = [p.get() for p in parts]
        out = np.zeros((sum(len(r["translation"]) for r in rows), 2))
        for k, r in enumerate(rows):
            out[k::len(rows)] = r["translation"]
        return out, max(r["seconds"] for r in rows)

    want64, c_s = interleave(closures64)
    card_sub = meas.translation[::CLOSURE_CPU_STRIDE].double().cpu().numpy()
    c_line = _float32_gate("seq2loop closures", card_sub, want64, float32_rows=lambda rows: (
        interleave(closures_cpu(rows, "float32", 1))[0]))
    g64 = graph64.get()
    g_line = _float32_gate(
        "seq2loop graph solve", opt.poses.translation.double().cpu().numpy(), g64["translation"],
        float32_rows=lambda rows: pool.apply_async(_phase10_reference, ("seq2loop_graph", (
            fields, n_loop, "float32"))).get()["translation"][rows])
    _say("back-seq2loop", f"every {CLOSURE_CPU_STRIDE}th closure ({len(card_sub)}) from the card's "
                          f"seeds against the CPU ({c_s:.1f} s): {c_line}; the card's graph "
                          f"solved on the CPU (scale f64 {g64['scale']:.6g} vs the card's "
                          f"{scale:.6g}, {g64['seconds']:.1f} s): {g_line}")
    del opt


def _phase_back_end(torch, np, icp, dev, refs, pool) -> tuple[dict, float, str]:
    """Phase 10: the pose-graph back end; returns the launches of each path,
    K1/K2's deviation on the closure batch and that case's label.  10d's
    card part runs first, so that its CPU runs overlap 10a-c."""
    seconds, t0 = {}, time.perf_counter()

    def done(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    seq2loop = _back_end_seq2loop(torch, np, icp, dev, pool)
    paths, err, label = next(seq2loop)
    done("d (card)")
    _back_end_g2o(torch, np, icp, dev, refs)
    done("a")
    _back_end_synthetic(torch, np, icp, dev)
    done("b")
    _back_end_robust(torch, np, icp, dev)
    done("c")
    next(seq2loop, None)
    done("d (CPU check)")
    _say("back-seconds", ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return paths, err, label

# Phase 11: online SLAM and place recognition, after bench.py::run_online_slam
# (:1248-1339, its seq2loop rows: the configuration at :1276-1284),
# tests/test_seq2loop_slam.py (the gates: :99-131), bench.py::run_descriptor
# (:637-688) and examples/place_recognition.py (:80, :94: relocalization with
# no pose prior at descriptor range 30).  The driver runs 50 iterations a
# scan, as in the test's fixture (:75-87): under the bench's tolerances (0.1
# deg, 1 cm) the JAX package itself ends the stream at a keyframe ATE of 2.28
# m, so the test's 0.3 m gate holds only there.
SLAM_CFG = dict(max_iterations=50)
SLAM_KW = dict(translation_threshold=0.5, angle_threshold=0.15, loop_every=8, loop_radius=2.0,
               loop_min_separation=10, robust="gnc_gm", robust_scale="auto",
               odometry_weight=100.0, loop_weight=100.0)
SLAM_MODES = ("serial", "pipelined")
SLAM_TIMED, SLAM_WARMUP_SCANS = 1, 24  # timed passes, warm-up sweeps: both cut (PERF.md §4)
# The CPU runs stream the first SLAM_GATED sweeps (the stream is causal: the
# same computation as the card's up to there, four closure solves included).
SLAM_GATED = 176
SLAM_ATE_M, SLAM_FIRST_CLOSURE_BEFORE = 0.3, 160
LAP = 120  # seq2loop's lap: scan 120 + k revisits scan k
DESC_T, DESC_N, DESC_RANGE, DESC_ROWS, DESC_REPS = 1024, 1024, 30.0, 64, 5
RELOC_SWEEPS = tuple(range(LAP, 2 * LAP, 15))  # 8 lap-2 sweeps


def _slam_stream(slam, icp, clouds, mode, dev, record=None, capture=None, async_refine=False):
    """One OnlineSlam pass of phase 11's configuration over ``clouds``, then
    ``finalize``: (session, keyframe scan indices, (scan, closures) of each
    scan whose refinement solved or, with ``async_refine``, whose update
    applied a solve, the capture, and whether a solve was outstanding at
    ``finalize``).  ``record`` collects each add_scan's seconds; after
    ``capture`` scans the keyframe indices so far, the keyframe translations
    and the closure count are captured (pipelined: the scans materialized by
    then).  ``async_refine="pinned"`` waits for each solve before the next
    scan and applies an outstanding one before the capture."""
    online = slam.OnlineSlam(icp.from_method("trimmed", 2, icp.Config(overlap_rate=0.9)),
                             icp.DriverConfig(**SLAM_CFG), pipelined=mode == "pipelined",
                             async_refine=bool(async_refine), device=dev, **SLAM_KW)
    pinned = async_refine == "pinned"
    updates, captured = [], None
    for scan in clouds:
        if pinned and online._async_solve is not None:
            online._async_solve.block_until_ready()
        t0 = time.perf_counter()
        u = online.add_scan(scan)
        if record is not None:
            record.append(time.perf_counter() - t0)
        updates.append(u)
        if len(updates) == capture:
            if pinned:
                online._maybe_apply_async(force=True)
            done = [v for v in updates if v is not None]
            captured = ([t for t, v in enumerate(done) if v.is_keyframe],
                        online.keyframe_poses.translation.double().cpu().numpy(),
                        len(online._loop_edges))
    updates = [u for u in updates + [online.flush()] if u is not None]
    outstanding = online._async_solve is not None
    online.finalize()
    keyframes = [t for t, u in enumerate(updates) if u.is_keyframe]
    refined = [(t, u.num_closures) for t, u in enumerate(updates) if u.refined]
    return online, keyframes, refined, captured, outstanding


def _phase11_reference(mode: str, dtype: str, ulp: int = 0, async_refine=False) -> dict:
    """Phase 11a's stream on the CPU over the first SLAM_GATED sweeps (a
    worker process's job, one thread): the keyframe scan indices and
    translations there.  ``ulp`` = +-1 moves every float32 coordinate one
    ulp up or down first (the float32 rule of phase 8e); ``async_refine``
    ("pinned") is phase 12a's pinned asynchronous stream."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    import icp_tpu_torch as icp
    from icp_tpu_torch import slam

    t0 = time.perf_counter()
    sweeps = _seq2loop(np)[0][:SLAM_GATED]
    if ulp:
        sweeps = [np.nextafter(a.astype(np.float32), np.float32(ulp * np.inf)) for a in sweeps]
    clouds = [icp.from_points(a, capacity=CAPACITY, dtype=getattr(torch, dtype), device="cpu")
              for a in sweeps]
    _, _, _, (keyframes, translation, closures), _ = _slam_stream(
        slam, icp, clouds, mode, "cpu", capture=SLAM_GATED, async_refine=async_refine)
    return {"keyframes": keyframes, "translation": translation, "closures": closures,
            "seconds": time.perf_counter() - t0}


def _slam_float32_gate(label: str, got, cpu: dict, float32_runs) -> str:
    """Max |dt| of the card's keyframe translations from CPU float64, gate
    POSE_AGREEMENT_TOL_M.  Phase 8e's float32 rule, read for a stream: its
    keyframes share one chain of roundoff, so they are not independent
    lanes and the miss is the stream's.  A card stream over the gate passes only when a
    CPU float32 run of the same stream misses the gate too (from the same
    sweeps, or from sweeps moved one ulp either way: ``float32_runs(ulp)``
    gives their translations, on demand), and the card stays within twice
    the largest float32 deviation."""
    import numpy as np

    want64 = cpu["translation"]
    dev = np.linalg.norm(np.asarray(got, dtype=np.float64) - want64, axis=-1)
    over = np.flatnonzero(dev > POSE_AGREEMENT_TOL_M)
    line = (f"CUDA f32 vs CPU f64 max |dt| {dev.max():.4e} m (gate {POSE_AGREEMENT_TOL_M}), "
            f"{len(over)} of {len(dev)} over it")
    if not len(over):
        return line
    runs, worst = [], 0.0
    for ulp in (0, 1, -1):  # the perturbed runs only while the rule is not met
        dev32 = np.linalg.norm(float32_runs(ulp) - want64, axis=-1)
        worst = max(worst, dev32.max())
        runs.append(f"CPU f32{f' {ulp:+d} ulp' if ulp else ''} max {dev32.max():.4e} m, "
                    f"{int((dev32 > POSE_AGREEMENT_TOL_M).sum())} over")
        if worst > POSE_AGREEMENT_TOL_M and dev.max() <= 2 * worst:
            return f"{line}; the CPU float32 runs miss it too ({'; '.join(runs)}): float32's"
    raise AssertionError(f"{label}: over the gate from CPU f64 beyond float32's own "
                         f"deviation ({line}; {'; '.join(runs)})")


def _warm_solves(torch, icp, dev) -> None:
    """One single-pass and one two-pass refinement solve on a 12-node chain
    with 2 closures: the solver libraries initialize here, not in the first
    timed refinement (the warm-up pass over 24 sweeps closes no loop)."""
    from icp_tpu_torch import slam

    n = 12
    poses = icp.identity(2, (n,), dtype=torch.float32, device=dev)
    odo = icp.RigidTransform(poses.rotation[1:], torch.full((n - 1, 2), 0.5, device=dev))
    loop = icp.identity(2, (2,), dtype=torch.float32, device=dev)
    graph, mask = slam._assemble_graph(
        poses, odo, torch.full((n - 1,), 100.0, device=dev),
        torch.tensor([[0, 10], [1, 11]], dtype=torch.int32, device=dev), loop,
        torch.full((2,), 100.0, device=dev), None)
    slam._solve_single(graph, mask, SLAM_KW["robust"], "auto", 30, "dense")
    slam._solve_two_pass(graph, mask, odo, "welsch", "auto", 2, 30, "dense")
    torch.cuda.synchronize()


def _kf_ate(icp, torch, np, ev, poses, gt, scans) -> float:
    """Keyframe ATE (mean, m) against the ground truth, first-pose aligned
    (the SLAM frame is scan 0's; tests/test_seq2loop_slam.py:113-131)."""
    truth = _gt_transform(icp, torch, np, gt[np.asarray(scans)])
    return float(ev.ate(icp.RigidTransform(poses.rotation.double().cpu(),
                                           poses.translation.double().cpu()),
                        truth, align="first").mean)


def _slam_streams(torch, np, icp, dev, sweeps, gt) -> tuple[dict, dict, dict, dict]:
    """Phase 11a on the card: the 240-sweep stream, serial and pipelined;
    returns the launches of each path, each mode's last session with its
    keyframe scan indices, what it captured after SLAM_GATED sweeps, and
    its keyframe ATE, add_scan seconds and refining scans (phase 12a's
    comparison)."""
    from icp_tpu_torch import eval as ev
    from icp_tpu_torch import slam

    clouds = [icp.from_points(a, capacity=CAPACITY, dtype=torch.float32, device=dev)
              for a in sweeps]
    paths, sessions, captured, stats = {}, {}, {}, {}
    _warm_solves(torch, icp, dev)
    for mode in SLAM_MODES:
        _slam_stream(slam, icp, clouds[:SLAM_WARMUP_SCANS], mode, dev)  # warm-up
        p50, p99, stalls = [], [], []
        for rep in range(SLAM_TIMED):
            times = []
            if rep == 0:
                _reset_launches()
            online, keyframes, refined, captured[mode], _ = _slam_stream(
                slam, icp, clouds, mode, dev, times, capture=SLAM_GATED)
            torch.cuda.synchronize()
            if rep == 0:
                paths[f"slam {mode}"] = _read_launches()
            # The first scan only promotes; the refining scans carry the solve.
            ms = np.asarray(times[1:]) * 1e3
            p50.append(float(np.percentile(ms, 50)))
            p99.append(float(np.percentile(ms, 99)))
            # Pipelined updates land one scan late: the solve runs in the
            # add_scan after the refining scan's.
            lag = 1 if mode == "pipelined" else 0
            stalls.append(max((times[t + lag] for t, _ in refined if t + lag < len(times)),
                              default=0.0) * 1e3)
        sessions[mode] = (online, keyframes)
        ate = _kf_ate(icp, torch, np, ev, online.keyframe_poses, gt, keyframes)
        accepting = [t for t, n in refined if n > 0 and t < len(clouds) - 1]
        if not ate <= SLAM_ATE_M:
            raise AssertionError(f"slam {mode}: keyframe ATE {ate} > {SLAM_ATE_M} m")
        if not accepting or accepting[0] >= SLAM_FIRST_CLOSURE_BEFORE:
            raise AssertionError(f"slam {mode}: no closure accepted before scan "
                                 f"{SLAM_FIRST_CLOSURE_BEFORE} (refines {refined[:6]})")
        stats[mode] = {"ate": ate, "times": times, "refined": refined}
        _say("slam", f"{mode}, {len(clouds)} seq2loop sweeps at {CAPACITY}: add_scan p50 "
                     f"{np.median(p50):.2f} ms, p99 {np.median(p99):.2f} ms (median of "
                     f"{SLAM_TIMED} passes: p50 {', '.join(f'{x:.2f}' for x in p50)}; p99 "
                     f"{', '.join(f'{x:.2f}' for x in p99)}), refine stall "
                     f"{np.median(stalls):.2f} ms (the slowest refining scan: "
                     f"{', '.join(f'{x:.2f}' for x in stalls)}); {len(keyframes)} keyframes, "
                     f"{len(online._loop_edges)} closures, {len(refined)} refining solves, the "
                     f"first accepting at scan {accepting[0]}; keyframe ATE {ate:.4f} m (gate "
                     f"{SLAM_ATE_M}); launches {paths[f'slam {mode}']}")
    return paths, sessions, captured, stats


def _slam_cpu_check(captured, slam_refs) -> None:
    """Phase 11a against the CPU: the keyframe decisions and poses after the
    first SLAM_GATED sweeps.  ``slam_refs`` is (the worker pool, its runs
    by (mode, dtype[, ulp])); a float32 run not queued at the start is
    queued when a miss needs it.  The float32 rule: a miss counts as float32's
    only if a CPU float32 run misses too."""
    pool, refs = slam_refs
    for mode in SLAM_MODES:
        keyframes, got, _ = captured[mode]
        cpu = refs[mode, "float64"].get()

        def float32_run(ulp, mode=mode):
            if (mode, "float32", ulp) not in refs:
                refs[mode, "float32", ulp] = pool.apply_async(
                    _phase11_reference, (mode, "float32", ulp))
            return refs[mode, "float32", ulp].get()

        line = (f"slam {mode}, the first {SLAM_GATED} sweeps, vs CPU f64 "
                f"({cpu['seconds']:.1f} s): ")
        if keyframes == cpu["keyframes"]:
            line += f"{len(keyframes)} keyframe indices equal, " + _slam_float32_gate(
                f"slam {mode}", got, cpu, lambda ulp, run=float32_run: run(ulp)["translation"])
        else:
            if float32_run(0)["keyframes"] == cpu["keyframes"]:
                raise AssertionError(f"slam {mode}: keyframe indices differ from CPU f64 "
                                     f"where CPU f32 keeps them")
            line += (f"keyframe indices differ ({len(keyframes)} vs {len(cpu['keyframes'])}), "
                     f"and CPU f32's differ too: float32's")
        _say("slam-cpu", line + f"; closures by then: CPU f64 {cpu['closures']}")


def _descriptor_shapes(torch, np, dev) -> dict:
    """Phase 11b: bench.py::run_descriptor's shapes (1,024 scans of 1,024
    points, a 20 x 60 grid at radius 30; the 1,024-keyframe all-pairs
    retrieval), CUDA events, median of 5; 64 query rows against CPU
    float64 on the card's descriptors."""
    from icp_tpu_torch.ops import descriptor as desc

    rng = np.random.default_rng(17)
    pts = torch.tensor(rng.uniform(-20, 20, (DESC_T, DESC_N, 2)), dtype=torch.float32,
                       device=dev)
    mask = torch.ones((DESC_T, DESC_N), dtype=torch.bool, device=dev)

    def timed(fn):
        out, times = fn(), []
        for _ in range(DESC_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return out, float(np.median(times)), times

    _reset_launches()
    descs, build_ms, build_t = timed(lambda: desc.scan_context(pts, mask, max_radius=DESC_RANGE))
    (dist, shift), ret_ms, ret_t = timed(lambda: desc.descriptor_distances(descs))
    launches = _read_launches()
    # Build: the card's float32 against CPU float64 on the same points (a
    # point on a bin edge may land on either side).
    rows = np.arange(0, DESC_T, DESC_T // DESC_ROWS)
    built64 = desc.scan_context(pts[rows].double().cpu(), mask[rows].cpu(), max_radius=DESC_RANGE)
    bins_off = int((descs[rows].double().cpu() - built64).abs().gt(1e-4).sum())
    # Retrieval: 64 query rows against the CPU float64 run on the card's
    # descriptors; shifts where the best leads the next by more than 1e-5.
    d64 = descs.double().cpu()
    want_d, want_s = desc.descriptor_query(d64[rows], d64)
    got_d = dist[torch.as_tensor(rows, device=dev)].double().cpu()
    got_s = shift[torch.as_tensor(rows, device=dev)].cpu()
    err = float((got_d - want_d).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"descriptor retrieval: |dist - CPU f64| {err} > 1e-5")
    unit = d64 / d64.norm(dim=-2, keepdim=True).clamp(min=1e-300)
    flat_q = unit[rows].reshape(len(rows), -1)
    per_shift = torch.stack([1.0 - flat_q @ torch.roll(unit, -s, dims=-1).reshape(DESC_T, -1).T
                             / unit.shape[-1] for s in range(unit.shape[-1])]).sort(0).values
    clear = (per_shift[1] - per_shift[0]) > 1e-5
    bad = int((got_s != want_s)[clear].sum())
    if bad:
        raise AssertionError(f"descriptor retrieval: {bad} shifts differ where clear")
    _say("descriptor", f"scan_context ({DESC_T}, {DESC_N}, 2) -> 20 x 60: {build_ms:.3f} ms "
                       f"(median of {DESC_REPS}: {', '.join(f'{x:.3f}' for x in build_t)}); "
                       f"all-pairs retrieval {DESC_T} x {DESC_T} x 60 shifts: {ret_ms:.3f} ms "
                       f"({', '.join(f'{x:.3f}' for x in ret_t)}); {len(rows)} query rows vs "
                       f"CPU f64: max |d dist| {err:.3e} (gate 1e-5), shifts equal on "
                       f"{int(clear.sum())} clear pairs ({int((~clear).sum())} near-ties "
                       f"skipped); build vs CPU f64: {bins_off} of {built64.numel()} bins off by "
                       f"> 1e-4; launches {launches}")
    return {"descriptor build + retrieval": launches}


def _relocalize_laps(torch, np, icp, dev, serial, sweeps, gt) -> dict:
    """Phase 11c: 8 lap-2 sweeps relocalized with no pose prior against the
    serial session's lap-1 keyframes."""
    from icp_tpu_torch import slam

    online, keyframes = serial
    lap1 = [k for k, t in enumerate(keyframes) if t < LAP]
    idx = torch.as_tensor(lap1, device=dev)
    clouds = online._folded_clouds()
    stack = icp.PointCloud(clouds.points[idx], clouds.count[idx])
    poses = online.keyframe_poses
    kf_poses = icp.RigidTransform(poses.rotation[idx], poses.translation[idx])
    truth = _gt_transform(icp, torch, np, gt)
    t0_inv = icp.inverse(icp.RigidTransform(truth.rotation[0], truth.translation[0]))
    _reset_launches()
    results, t0 = [], time.perf_counter()
    for q in RELOC_SWEEPS:
        scan = icp.from_points(sweeps[q], capacity=CAPACITY, dtype=torch.float32, device=dev)
        results.append(slam.relocalize(scan, stack, kf_poses, online._method, online._config,
                                       descriptor_range=DESC_RANGE))
    torch.cuda.synchronize()
    seconds, launches = time.perf_counter() - t0, _read_launches()
    lines = []
    for q, res in zip(RELOC_SWEEPS, results):
        if res is None:
            lines.append(f"{q}: none")
            continue
        want = icp.compose(t0_inv, icp.RigidTransform(truth.rotation[q], truth.translation[q]))
        err = float(np.linalg.norm(res.pose.translation.double().cpu().numpy()
                                   - want.translation.numpy()))
        if not math.isfinite(err):
            raise AssertionError(f"relocalize sweep {q}: non-finite pose")
        lines.append(f"{q}: kf {res.keyframe} (scan {keyframes[lap1[res.keyframe]]}), error "
                     f"{err:.4f} m, dist {res.descriptor_distance:.3f}, cost {res.cost:.4g}")
    found = sum(r is not None for r in results)
    _say("relocalize", f"{found} of {len(RELOC_SWEEPS)} lap-2 sweeps relocalized against "
                       f"{len(lap1)} lap-1 keyframes (no pose prior, range {DESC_RANGE}) in "
                       f"{seconds * 1e3:.1f} ms; " + "; ".join(lines) + f"; launches {launches}")
    return {"relocalize": launches}


def _merge_laps(torch, np, icp, dev, sweeps, gt) -> dict:
    """Phase 11d: the two laps as separate descriptor-mode sessions, merged
    with anchor=None (the anchor recovered by relocalization)."""
    from icp_tpu_torch import eval as ev
    from icp_tpu_torch import slam

    clouds = [icp.from_points(a, capacity=CAPACITY, dtype=torch.float32, device=dev)
              for a in sweeps]
    kw = dict(SLAM_KW, loop_detector="descriptor", descriptor_range=DESC_RANGE)
    method = icp.from_method("trimmed", 2, icp.Config(overlap_rate=0.9))
    laps, t0 = [], time.perf_counter()
    for lo in (0, LAP):
        online = slam.OnlineSlam(method, icp.DriverConfig(**SLAM_CFG), device=dev, **kw)
        kfs = [lo + t for t in range(LAP) if online.add_scan(clouds[lo + t]).is_keyframe]
        online.finalize()
        laps.append((online, kfs))
    stream_s = time.perf_counter() - t0
    (a, kfa), (b, kfb) = laps
    _reset_launches()
    t0 = time.perf_counter()
    merged, report = slam.merge_sessions(a, b)
    torch.cuda.synchronize()
    merge_s, launches = time.perf_counter() - t0, _read_launches()
    anchor_t = report.anchor.translation.double().cpu().numpy()
    anchor_a = math.degrees(float(torch.atan2(report.anchor.rotation[1, 0],
                                              report.anchor.rotation[0, 0])))
    ates = [_kf_ate(icp, torch, np, ev, s.keyframe_poses, gt, k) for s, k in laps]
    ate = _kf_ate(icp, torch, np, ev, merged.keyframe_poses, gt, kfa + kfb)
    if not (np.isfinite(anchor_t).all() and math.isfinite(ate)):
        raise AssertionError(f"merge: non-finite anchor {anchor_t} or ATE {ate}")
    _say("merge", f"laps of {len(kfa)} + {len(kfb)} keyframes ({len(a._loop_edges)} + "
                  f"{len(b._loop_edges)} closures; streamed in {stream_s:.1f} s, keyframe ATE "
                  f"{ates[0]:.4f} / {ates[1]:.4f} m); merge_sessions(anchor=None) in "
                  f"{merge_s:.2f} s: anchor translation {np.round(anchor_t, 4).tolist()} m, "
                  f"angle {anchor_a:.3f} deg (ground truth: identity), {report.new_closures} "
                  f"new closures, refined {report.refined}; merged keyframe ATE {ate:.4f} m; "
                  f"launches {launches}")
    return {"merge_sessions": launches}



# Phase 12: asynchronous refinement and the user surfaces.  (a) phase 11a's
# stream with OnlineSlam(async_refine=True), bench.py::run_online_slam's
# pipelined_async row (:1297-1320; its stall is the worst scan, :1314-1318),
# serial and pipelined over the first SLAM_GATED sweeps, timed as users run
# it and then with the timing pinned (each solve waited for before the next
# scan), against 11a's synchronous captures; (b) the native CSV loader; (c) utils/profiling's
# trace of the main path; (d) cli view and cli bench; (e) the examples.
VIEW_ITERATIONS = 20
BENCH_METHODS = ("vanilla", "trimmed", "feature_aware")  # the reference's 2D methods
EXAMPLES = {"register_pair": "translation:", "serving_demo": "max pose error",
            "slam_pipeline": "optimized end-pose drift",
            "place_recognition": "descriptor search", "odometry_sequence": "optimized ATE",
            "odometry_sequence_3d": "after closure", "online_slam": "stream done",
            "multi_session_merge": "merged sessions:", "fleet_registration": "pairs on"}
EXAMPLE_TIMEOUT_S = 400
SCRATCH = os.path.join(REPO, "build", "chip_smoke")  # gitignored


def _start_examples(dev) -> dict:
    """Phase 12e: every example as ``python -m icp_tpu_torch.examples.NAME``
    at ICP_EXAMPLES_QUICK=1 on the card, started together; returns the
    processes and their output files."""
    out_dir = os.path.join(SCRATCH, "examples")
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO, ICP_EXAMPLES_QUICK="1", ICP_EXAMPLES_OUT=out_dir)
    env.pop("ICP_EXAMPLES_CPU", None)
    procs = {}
    for name in EXAMPLES:
        log = open(os.path.join(out_dir, f"{name}.log"), "w+")
        procs[name] = (subprocess.Popen([sys.executable, "-m", f"icp_tpu_torch.examples.{name}"],
                                        stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO),
                       log, time.perf_counter())
    return procs


def _finish_examples(procs) -> None:
    """Wait for phase 12e's processes; each must exit 0 with its key line."""
    lines, bad = [], []
    for name, (proc, log, t0) in procs.items():
        try:
            code = proc.wait(timeout=max(1.0, EXAMPLE_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            code = "timeout"
        log.seek(0)
        text = log.read()
        log.close()
        key = [line for line in text.splitlines() if EXAMPLES[name] in line]
        lines.append(f"{name}: exit {code}, " + (key[-1].strip() if key else "no key line"))
        if code != 0 or not key:
            bad.append(f"{name} (exit {code}): {text[-1500:]}")
    _say("examples", f"{len(EXAMPLES)} examples at ICP_EXAMPLES_QUICK=1 on the card: "
                     + "; ".join(lines))
    if bad:
        raise AssertionError("examples failed: " + " | ".join(bad))


def _pinned_gate(mode: str, got, want, cpu32=None) -> str:
    """Phase 12a's pinned stream against 11a's synchronous capture: keyframe
    indices and closures equal, keyframe translations within
    POSE_AGREEMENT_TOL_M.  A pipelined miss counts as float32's only when
    the CPU float32 pinned run (``cpu32()``: (pinned, synchronous)) misses
    its own synchronous run too."""
    import numpy as np

    (kf_g, tr_g, cl_g), (kf_w, tr_w, cl_w) = got, want
    same = kf_g == kf_w and cl_g == cl_w
    dev = (float(np.linalg.norm(tr_g - tr_w, axis=-1).max()) if tr_g.shape == tr_w.shape
           else math.inf)
    line = (f"{mode} pinned, {SLAM_GATED} sweeps, vs 11a's synchronous run: keyframe indices "
            f"{'equal' if kf_g == kf_w else f'differ ({len(kf_g)} vs {len(kf_w)})'}, "
            f"closures {cl_g} vs {cl_w}, max |dt| {dev:.4e} m (gate {POSE_AGREEMENT_TOL_M})")
    if same and dev <= POSE_AGREEMENT_TOL_M:
        return line
    if mode != "pipelined":
        raise AssertionError(f"slam {mode} pinned: {line}")
    pinned, sync = cpu32()
    dev32 = (float(np.linalg.norm(pinned["translation"] - sync["translation"], axis=-1).max())
             if pinned["translation"].shape == sync["translation"].shape else math.inf)
    same32 = pinned["keyframes"] == sync["keyframes"] and pinned["closures"] == sync["closures"]
    line += (f"; CPU f32 pinned vs CPU f32 synchronous: decisions "
             f"{'equal' if same32 else 'differ'}, max |dt| {dev32:.4e} m")
    if (not same and not same32) or (same and dev32 > POSE_AGREEMENT_TOL_M):
        return line + ": the CPU float32 run misses too, float32's"
    raise AssertionError(f"slam {mode} pinned: {line}")


def _stream_stats(np, times, refined, lag: int, scans: int) -> dict:
    """add_scan p50 and p99 (the first scan only promotes) and the stall over
    the first ``scans`` scans: the slowest scan that ran a refinement's solve
    (``refined``'s scans, ``lag`` scans later) or, asynchronous (``refined``
    None), the slowest scan (``bench.py:1314-1318``), in ms."""
    ms = np.asarray(times[1:scans]) * 1e3
    if refined is None:
        stall = float(ms.max())
    else:
        stall = max((times[t + lag] for t, _ in refined if t + lag < scans), default=0.0) * 1e3
    return {"p50": float(np.percentile(ms, 50)), "p99": float(np.percentile(ms, 99)),
            "stall": stall}


def _async_streams(torch, np, icp, dev, sweeps, gt, phase11) -> dict:
    """Phase 12a, timed: the asynchronous streams as users run them (no part
    of the session replaced), serial and pipelined over the first
    SLAM_GATED sweeps (the script's time), each beside 11a's synchronous
    numbers over the same sweeps and its capture there; the worker's device
    ms per solve from the CUDA events the session records around each
    solve.  Returns the launches of each stream."""
    from icp_tpu_torch import eval as ev
    from icp_tpu_torch import slam

    scans = SLAM_GATED
    clouds = [icp.from_points(a, capacity=CAPACITY, dtype=torch.float32, device=dev)
              for a in sweeps[:scans]]
    paths = {}
    for mode in SLAM_MODES:
        times = []
        _reset_launches()
        online, keyframes, applied, _, outstanding = _slam_stream(
            slam, icp, clouds, mode, dev, times, async_refine=True)
        torch.cuda.synchronize()
        paths[f"slam {mode} async"] = _read_launches()
        solve_ms = [start.elapsed_time(end) for start, end in online._solve_events]
        got = _stream_stats(np, times, None, 0, scans)
        sync = phase11["stats"][mode]
        want = _stream_stats(np, sync["times"], sync["refined"], int(mode == "pipelined"), scans)
        ate = _kf_ate(icp, torch, np, ev, online.keyframe_poses, gt, keyframes)
        mid = [t for t, _ in applied if t < scans - 1]
        sync_kf, kf_s, sync_closures = phase11["captured"][mode]  # after SLAM_GATED sweeps
        kf_a = online.keyframe_poses.translation.double().cpu().numpy()
        if kf_a.shape == kf_s.shape:
            deviation = (f"max keyframe |dt| from 11a "
                         f"{np.linalg.norm(kf_a - kf_s, axis=-1).max():.4e} m")
        else:
            deviation = f"{len(kf_a)} keyframes vs 11a's {len(kf_s)}: not comparable"
        _say("slam-async", f"{mode}, {scans} sweeps, async_refine=True (11a synchronous over "
                           f"the same sweeps in brackets): add_scan p50 {got['p50']:.2f} ms "
                           f"({want['p50']:.2f}), p99 {got['p99']:.2f} ms ({want['p99']:.2f}), "
                           f"worst scan {got['stall']:.2f} ms (refine stall "
                           f"{want['stall']:.2f}); after finalize {len(keyframes)} keyframes "
                           f"and {len(online._loop_edges)} closures (11a's capture at sweep "
                           f"{scans}, before finalize: {len(sync_kf)} and {sync_closures}); "
                           f"corrections "
                           f"applied mid-stream {len(mid)} (first at scan "
                           f"{mid[0] if mid else None}), at finalize {int(outstanding) + 1} (an "
                           f"outstanding solve: {outstanding}; finalize's own); worker solve "
                           f"device ms {', '.join(f'{x:.1f}' for x in solve_ms)}; keyframe ATE "
                           f"{ate:.4f} m ({sync['ate']:.4f} over 240 sweeps; gate {SLAM_ATE_M}); "
                           f"{deviation} (not gated); launches {paths[f'slam {mode} async']}")
        if not ate <= SLAM_ATE_M:
            raise AssertionError(f"slam {mode} async: keyframe ATE {ate} > {SLAM_ATE_M} m")
        if not mid:
            raise AssertionError(f"slam {mode} async: no correction applied mid-stream")
    return paths


def _pinned_stream(mode: str) -> dict:
    """Phase 12a's pinned stream on the card over the first SLAM_GATED
    sweeps (a card worker process's job, beside the untimed rest of phases
    11 and 12): the keyframe scan indices, translations and closures
    there."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    import icp_tpu_torch as icp
    from icp_tpu_torch import slam

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    clouds = [icp.from_points(a, capacity=CAPACITY, dtype=torch.float32, device=dev)
              for a in _seq2loop(np)[0][:SLAM_GATED]]
    _, _, _, (keyframes, translation, closures), _ = _slam_stream(
        slam, icp, clouds, mode, dev, capture=SLAM_GATED, async_refine="pinned")
    return {"keyframes": keyframes, "translation": translation, "closures": closures,
            "seconds": time.perf_counter() - t0}


def _pinned_check(pinned: dict, captured: dict, slam_refs) -> None:
    """Phase 12a, pinned: the check that the asynchronous handoff (the
    corrected pipelined one too) equals the synchronous re-anchor."""
    pool, refs = slam_refs
    for mode in SLAM_MODES:
        got = pinned[mode].get()

        def cpu32(mode=mode):
            if (mode, "float32", 0) not in refs:
                refs[mode, "float32", 0] = pool.apply_async(_phase11_reference, (mode, "float32"))
            if (mode, "float32", 0, "pinned") not in refs:
                refs[mode, "float32", 0, "pinned"] = pool.apply_async(
                    _phase11_reference, (mode, "float32", 0, "pinned"))
            return refs[mode, "float32", 0, "pinned"].get(), refs[mode, "float32", 0].get()

        line = _pinned_gate(mode, (got["keyframes"], got["translation"], got["closures"]),
                            captured[mode], cpu32)
        _say("slam-pinned", f"{line}; streamed in {got['seconds']:.1f} s in a card worker")


def _native_loader(torch, np, sweeps, dev, native_build) -> None:
    """Phase 12b: the 240 seq2loop sweeps as CSV scans at capacity 1,024,
    through the native threaded loader and through the Python path.
    ``native_build``: (the library was in the checkout, seconds to load or
    build it at the start)."""
    from icp_tpu_torch.io import scan_csv
    from icp_tpu_torch.utils import native

    out = os.path.join(SCRATCH, "seq2loop_csv")
    os.makedirs(out, exist_ok=True)
    paths = []
    for i, pts in enumerate(sweeps):
        path = os.path.join(out, f"scan_{i:03d}.csv")
        with open(path, "w") as f:
            f.write("\n".join(f"{float(x)!r},{float(y)!r}" for x, y in pts) + "\n")
        paths.append(path)
    had, load_s = native_build
    if native.native_lib() is None:
        raise AssertionError("the native library did not build or load (g++ and "
                             "native/src/icptpu_native.cpp)")

    def load():
        t0 = time.perf_counter()
        cloud = scan_csv.parse_lidar_scan_batch(paths, capacity=CAPACITY, device=dev)
        torch.cuda.synchronize()
        return cloud, (time.perf_counter() - t0) * 1e3

    fast, fast_ms = load()
    saved = native._LIB, native._TRIED
    native._LIB, native._TRIED = None, True  # the library absent: the Python path
    try:
        slow, slow_ms = load()
    finally:
        native._LIB, native._TRIED = saved
    if not (torch.equal(fast.points, slow.points) and torch.equal(fast.count, slow.count)):
        raise AssertionError("native loader: arrays or counts differ from the Python path")
    _say("native", f"native/libicptpu.so {'loaded' if had else 'built'} in {load_s:.2f} s; "
                   f"{len(paths)} CSV scans at capacity {CAPACITY} onto the card: native "
                   f"{fast_ms:.1f} ms, Python {slow_ms:.1f} ms; points and counts equal "
                   f"({int(fast.count.sum())} points)")


def _device_events(torch, prof) -> collections.Counter:
    """Device events (kernels and copies) of a finished torch.profiler run,
    by name."""
    return collections.Counter(e.name for e in prof.events()
                               if e.device_type == torch.autograd.DeviceType.CUDA)


def _trace_events(torch, prof) -> tuple[collections.Counter, collections.Counter]:
    """(device events, host events) of a finished torch.profiler run, by
    name: the host's are the ATen ops and the CUDA runtime calls."""
    host = collections.Counter(e.name for e in prof.events()
                               if e.device_type != torch.autograd.DeviceType.CUDA)
    return _device_events(torch, prof), host


# The CUDA runtime calls that issue device work: kernel launches and copies.
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


def _issued(host: collections.Counter) -> tuple[collections.Counter, collections.Counter]:
    """(ATen ops, runtime calls that issue device work) of ``host``; the other
    runtime calls (the caching allocator's cudaMalloc, cudaStreamIsCapturing
    and cudaEventQuery, synchronizations) are left out: they follow the
    allocator's state, not the path's work."""
    ops = collections.Counter({n: c for n, c in host.items() if not n.startswith("cu")})
    issued = collections.Counter({n: c for n, c in host.items() if n.startswith(LAUNCH_CALLS)})
    return ops, issued


def _profiling_trace(torch, icp, run, main: tuple, fine: dict) -> None:
    """Phase 12c: utils/profiling.trace of one main-path call against phase
    4's pass over the same call (``main``: its device events, its host events
    and K1/K2 launches per call).  Gates: the kernel launches and copies the
    host issued, the ATen ops and the K1/K2 launches equal phase 4's.  The
    device events are printed beside, not gated: CUPTI loses some of their
    records as the process ages (PERF.md §6), though every launch is on
    the host's record.  nn_roofline at the fine shape beside phase 3's
    bound."""
    from icp_tpu_torch.utils import profiling

    main_device, main_host, main_launches = main
    out = os.path.join(SCRATCH, "trace")
    _reset_launches()
    with profiling.trace(out) as prof:
        run()
    launches = _read_launches()
    device, host = _trace_events(torch, prof)
    (ops, issued), (main_ops, main_issued) = _issued(host), _issued(main_host)
    size = os.path.getsize(os.path.join(out, "trace.json"))
    roof = profiling.nn_roofline(CAPACITY, CAPACITY, 2, BATCH)
    flop_ms = roof["flops"] / PEAK_F32_FLOPS * 1e3
    byte_ms = roof["bytes"] / PEAK_HBM_BYTES * 1e3
    lost = sum(main_device.values()) - sum(device.values())
    _say("profiling", f"trace of one main-path call: {sum(issued.values())} kernel launches "
                      f"and copies issued (phase 4: {sum(main_issued.values())}), "
                      f"{sum(ops.values())} ATen ops (phase 4: {sum(main_ops.values())}), "
                      f"launches {launches} (phase 4: {main_launches}); device events recorded "
                      f"{sum(device.values())} (phase 4: {sum(main_device.values())}, {lost} "
                      f"fewer: records CUPTI lost, not gated), trace.json "
                      f"{size / 2**20:.1f} MiB; nn_roofline "
                      f"({BATCH}, {CAPACITY}, {CAPACITY}, 2): {roof['flops']:.4g} flops, "
                      f"{roof['bytes']:.4g} bytes, {roof['intensity_flops_per_byte']:.1f} "
                      f"flops/byte, {max(flop_ms, byte_ms):.4f} ms at the peaks (phase 3's "
                      f"bound for K1 {fine['K1_bound']:.4f} ms, its 3D - 1 flops per valid pair)")
    if issued != main_issued or ops != main_ops or launches != main_launches:
        moved = [(n, (main_issued + main_ops)[n], (issued + ops)[n])
                 for n in sorted(set(issued + ops) | set(main_issued + main_ops))
                 if (issued + ops)[n] != (main_issued + main_ops)[n]]
        raise AssertionError(f"profiling.trace: the host issued other work than phase 4's "
                             f"pass: launches {launches} vs {main_launches}; {moved[:10]}")


def _cli_view(torch, np, icp, dev) -> dict:
    """Phase 12d: cli view on scan1 trimmed for VIEW_ITERATIONS iterations on
    the card against CPU float64."""
    from icp_tpu_torch import cli, vis

    data = os.path.join(REPO, "ex_data")
    scan1 = [f"{data}/scan1/first.csv", f"{data}/scan1/second.csv"]
    a64, b64 = (icp.parse_lidar_scan(p, device="cpu") for p in scan1)
    *_, (_, want) = vis.registration_frames(icp.from_method("trimmed", 2), a64, b64,
                                            icp.identity(2, device="cpu"), VIEW_ITERATIONS)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        matplotlib = None
    _reset_launches()
    t0 = time.perf_counter()
    if matplotlib is None:
        _say("view", "matplotlib cannot be imported here: no frame is drawn; the frame-dump "
                     "loop (vis.registration_frames, the stepping cli view runs) is checked")
        a, b = (icp.parse_lidar_scan(p, dtype=torch.float32, device=dev) for p in scan1)
        *_, (_, last) = vis.registration_frames(
            icp.from_method("trimmed", 2), a, b,
            icp.identity(2, dtype=torch.float32, device=dev), VIEW_ITERATIONS)
        got, frames = last.translation, 0
    else:
        buf = io.StringIO()
        frames_dir = os.path.join(SCRATCH, "view")
        with contextlib.redirect_stdout(buf):
            cli.main(["view", "-S", scan1[0], "-D", scan1[1], "-m", "trimmed", "-l",
                      "--iterations", str(VIEW_ITERATIONS), "--out", frames_dir])
        dumps = [line for line in buf.getvalue().splitlines() if line.startswith("iteration=")]
        got = np.asarray(json.loads(dumps[-1].split(" t=", 1)[1]))
        frames = len([f for f in os.listdir(frames_dir) if f.endswith(".png")])
    torch.cuda.synchronize()
    view_s, launches = time.perf_counter() - t0, _read_launches()
    dt = float(np.linalg.norm(got - want.translation))
    _say("view", f"cli view scan1 trimmed, {VIEW_ITERATIONS} iterations on the card: {frames} "
                 f"frames in {view_s:.2f} s; last dump t {np.round(got, 6).tolist()} vs CPU "
                 f"f64 {np.round(want.translation, 6).tolist()}: |dt| {dt:.3e} m (gate "
                 f"{POSE_AGREEMENT_TOL_M}); launches {launches}")
    if not dt <= POSE_AGREEMENT_TOL_M:
        raise AssertionError(f"cli view: last frame {dt} m from CPU f64")
    return {f"cli view ({VIEW_ITERATIONS} frames)": launches}


def _cli_bench() -> None:
    """Phase 12d: cli bench on scans 1-3."""
    from icp_tpu_torch import cli

    data = os.path.join(REPO, "ex_data")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["bench", "--data-dir", data, "--scans", "1", "2", "3", "--invocations", "3",
                  "--batch", "256", "--methods", *BENCH_METHODS])
    cells, cell = [], {}
    for line in buf.getvalue().splitlines():
        if line.startswith("ICP method:"):
            cell = {"name": line.split(": ", 1)[1]}
            cells.append(cell)
        elif ": " in line:
            key, value = line.lstrip("* ").split(": ", 1)
            cell[key] = value
    _say("bench", f"cli bench, scans 1-3, 3 invocations, --batch 256, "
                  f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
                      f"{c['name']}: mean iterations {c['Mean iterations']}, mean cost "
                      f"{c['Mean cost']}, {c['Average time per invocation']} per invocation, "
                      f"{c.get('Batched throughput (256 pairs/invocation)')}" for c in cells))
    if len(cells) != 3 * len(BENCH_METHODS):
        raise AssertionError(f"cli bench printed {len(cells)} cells")


def _phase_slam_surfaces(torch, np, icp, dev, slam_refs, card_pool, run, main, fine,
                         native_build) -> dict:
    """Phases 11 and 12, interleaved so that the timed parts run alone: 11a,
    11b, 12a timed, 12b, 12d bench; then the pinned streams (two card worker
    processes) and the examples start, beside 11c, 11d, 12c and 12d view.
    Returns the launches of each path."""
    sweeps, gt, _ = _seq2loop(np)
    seconds, t0 = {}, time.perf_counter()

    def done(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    paths, sessions, captured, stats = _slam_streams(torch, np, icp, dev, sweeps, gt)
    _slam_cpu_check(captured, slam_refs)
    done("11a")
    paths.update(_descriptor_shapes(torch, np, dev))
    done("11b")
    phase11 = {"stats": stats, "captured": captured}
    paths.update(_async_streams(torch, np, icp, dev, sweeps, gt, phase11))
    done("12a timed")
    _native_loader(torch, np, sweeps, dev, native_build)
    done("12b")
    _cli_bench()
    done("12d bench")
    pinned = {mode: card_pool.apply_async(_pinned_stream, (mode,)) for mode in SLAM_MODES}
    procs = _start_examples(dev)
    try:
        paths.update(_relocalize_laps(torch, np, icp, dev, sessions["serial"], sweeps, gt))
        done("11c")
        paths.update(_merge_laps(torch, np, icp, dev, sweeps, gt))
        done("11d")
        _profiling_trace(torch, icp, run, main, fine)
        done("12c")
        paths.update(_cli_view(torch, np, icp, dev))
        done("12d view")
        _pinned_check(pinned, captured, slam_refs)
        done("12a pinned (the wait)")
        _finish_examples(procs)
        done("12e (the wait)")
    finally:
        for proc, log, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    _say("slam-seconds", ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    torch.cuda.empty_cache()
    return paths


# Phase 13: the parallel layer.  (a) runs at world size 1 on NCCL in a
# process of its own (the process group dies with it); (b) four gloo ranks on
# the one card, started beside (a) and released when (a) is done.  (a) times
# nothing until every rank of (b) has finished its set-up (CUDA, the process
# group, the inputs) and sits idle waiting for the release.
PARALLEL_DIR = os.path.join(SCRATCH, "parallel")
PARALLEL_RANKS = 4
PARALLEL_TIMEOUT_S = 240
BIG_CLOUD_ITERATIONS = 10  # tests/test_parallel.py's big-cloud budget
# The gate (on the reference's sqrt of the distance) trims 54.4% of the queen
# matches at the start and none by the tenth iterate (CPU float64); 1.0 would
# trim none.
BIG_CLOUD_GATE = 0.5
# Big cloud against the card's method iterate: the same arithmetic summed in
# another order (one packed all-reduce of one-pass sums, the method's
# centred two-pass covariance).  CPU float32 runs of the two differ on the
# queen pair by 1.8e-6 m and 1.1e-6 in rotation ungated, by 8.5e-6 m and
# 3.2e-6 at the gate; the bound is 2e-5.
FLOAT32_ROUNDING = 2e-5
# The kernels each phase-13 path must launch (by the path's name prefix).
PARALLEL_KERNELS = {"fleet": ("K2",), "converge": ("K1", "K2"), "big cloud": ("K1",),
                    "sharded_nn": ("K2",), "ring_nn": ("K2",)}


def _phase4_inputs(torch, np, icp, dev):
    """Phase 4's inputs: ``(a_pts, b_pts, angles, shifts)``, scan1's points
    and the seeded guesses as numpy arrays, and ``(source, target, guess,
    method, cfg)``, the 1,024 lanes on the card, the method and the bench's
    driver config (full resolution: 50 iterations, 0.1 deg, 0.01 m)."""
    data = os.path.join(REPO, "ex_data")
    a_pts = icp.io.parse_lidar_scan_array(f"{data}/scan1/first.csv")
    b_pts = icp.io.parse_lidar_scan_array(f"{data}/scan1/second.csv")
    a1 = icp.from_points(a_pts, capacity=CAPACITY, dtype=torch.float32, device=dev)
    b1 = icp.from_points(b_pts, capacity=CAPACITY, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    angles = rng.uniform(-0.05, 0.05, BATCH).astype(np.float32)
    shifts = rng.uniform(-0.2, 0.2, (BATCH, 2)).astype(np.float32)
    guess = icp.from_angle_2d(torch.tensor(angles, device=dev), torch.tensor(shifts, device=dev))
    method = icp.from_method("trimmed", 2, icp.Config(overlap_rate=0.9))
    cfg = icp.DriverConfig(
        max_iterations=50, angle_tolerance=0.1 * math.pi / 180, translation_tolerance=0.01
    )
    return ((a_pts, b_pts, angles, shifts),
            (icp.stack([a1] * BATCH), icp.stack([b1] * BATCH), guess, method, cfg))


def _queen_points(torch, icp, dev):
    return tuple(torch.tensor(icp.read_ply(os.path.join(REPO, p)), dtype=torch.float32,
                              device=dev) for p in QUEEN)


def _big_cloud_method(icp, gate):
    """The unsharded twin of big_cloud: vanilla 3D, or trimmed 3D at the gate."""
    if gate is None:
        return icp.from_method("vanilla", 3, icp.Config(solver="svd"))
    return icp.from_method("trimmed", 3, icp.Config(solver="svd", max_distance=gate))


def _phase13_reference(gate) -> dict:
    """Pool task: the method twin of big_cloud on the queen pair, CPU
    float64, BIG_CLOUD_ITERATIONS iterates (phase 13a's CPU gate)."""
    sys.path.insert(0, REPO)
    import icp_tpu_torch as icp

    src, dst = (icp.read_ply(os.path.join(REPO, p)) for p in QUEEN)
    method = _big_cloud_method(icp, gate)
    state = method.init(icp.from_points(src, device="cpu"), icp.from_points(dst, device="cpu"),
                        icp.identity(3, device="cpu"))
    for _ in range(BIG_CLOUD_ITERATIONS):
        state = method.iterate(state)
    return {"translation": state.transform.translation.numpy(),
            "rotation": state.transform.rotation.numpy()}


def _max_diff(a, b) -> float:
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def _interleaved(torch, runs: dict, reps: int = 3) -> dict:
    """Seconds per call of each run, interleaved: a warm-up round, then
    ``reps`` timed rounds."""
    times = {name: [] for name in runs}
    for rep in range(reps + 1):
        for name, run in runs.items():
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            if rep:
                times[name].append(time.perf_counter() - t0)
    return times


def _counted(torch, run):
    """``run()`` with the kernel counts zeroed just before and read just after."""
    _reset_launches()
    out = run()
    torch.cuda.synchronize()
    return out, _read_launches()


def _parallel_world1(out_dir: str) -> None:
    """Phase 13a in its own process: the fleet example, the main path's lanes
    through the sharded converge, big cloud, the NN merges and the
    edge-sharded PCG at world size 1 on NCCL.  Prints its lines, saves its
    poses for 13b and the CPU gate, and prints the paths' launches as the
    last line (JSON)."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    import icp_tpu_torch as icp
    from icp_tpu_torch import parallel as par
    from icp_tpu_torch import pose_graph
    from icp_tpu_torch.examples import fleet_registration
    from icp_tpu_torch.ops import pallas_nn

    dev = torch.device("cuda", 0)
    paths, saved = {}, {}
    clock = [time.perf_counter()]

    def lap() -> str:
        now = time.perf_counter()
        took, clock[0] = now - clock[0], now
        return f"; {took:.1f} s"
    torch.cuda.init()
    for r in range(PARALLEL_RANKS):
        _wait_for(os.path.join(out_dir, f"ready{r}"), PARALLEL_TIMEOUT_S / 2)
    _say("parallel", f"13b's {PARALLEL_RANKS} ranks set up and idle" + lap())
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, paths["fleet (B=64, world 1)"] = _counted(torch, fleet_registration.main)
    _say("parallel", f"fleet_registration (full size, world of one): "
                     f"{'; '.join(buf.getvalue().split(chr(10))[:2])}; "
                     f"{time.perf_counter() - t0:.2f} s, launches {paths['fleet (B=64, world 1)']}")

    mesh = par.make_mesh()
    _say("parallel", f"mesh {tuple(mesh.mesh.shape)} over {torch.distributed.get_world_size()} "
                     f"rank, backend {torch.distributed.get_backend()}, torch {torch.__version__}")

    # The main path's lanes: sharded (1, 1), points off and on, vs converge.
    source, target, guess, method, cfg = _phase4_inputs(torch, np, icp, dev)[1]
    fns = {sp: par.make_sharded_converge_fn(method, cfg, mesh, shard_points=sp)
           for sp in (False, True)}
    blocks = {sp: par.shard_batch((source, target, guess), mesh, sp) for sp in (False, True)}
    runs = {"converge": lambda: icp.converge(method, source, target, guess, cfg)[0],
            "sharded": lambda: fns[False](*blocks[False])[0],
            "sharded points": lambda: fns[True](*blocks[True])[0]}
    want = runs["converge"]()
    for name in ("sharded", "sharded points"):
        got, paths[f"converge {name} (1, 1)"] = _counted(torch, runs[name])
        equal = (torch.equal(got.iteration_count, want.iteration_count)
                 and torch.equal(got.transform.rotation, want.transform.rotation)
                 and torch.equal(got.transform.translation, want.transform.translation))
        if not equal:
            raise AssertionError(f"{name}: iterations or poses differ from converge")
    times = _interleaved(torch, runs, reps=5)
    _say("parallel", f"scan1 trimmed B={BATCH} (phase 4's lanes, full resolution): sharded "
                     "(1, 1) points off and on: iterations and poses bit-equal to converge; "
                     + ", ".join(f"{name} {BATCH / float(np.median(t)):.2f} pairs/s (median of "
                                 f"{len(t)}: {', '.join(f'{x * 1e3:.2f}' for x in t)} ms)"
                                 for name, t in times.items())
                     + f"; launches {paths['converge sharded points (1, 1)']}" + lap())
    # converge itself on a quarter of the lanes as one batch (13b's batch).
    quarter = slice(0, BATCH // 4)
    part, _ = icp.converge(method, icp.PointCloud(source.points[quarter], source.count[quarter]),
                           icp.PointCloud(target.points[quarter], target.count[quarter]),
                           icp.RigidTransform(guess.rotation[quarter], guess.translation[quarter]),
                           cfg)
    same = part.iteration_count == want.iteration_count[quarter]
    moved = torch.linalg.vector_norm(part.transform.translation
                                     - want.transform.translation[quarter], dim=-1)
    _say("parallel", f"converge on lanes 0-{BATCH // 4 - 1} as one batch against the same lanes in "
                     f"the batch of {BATCH} (no sharding; float32 sums split by batch size): "
                     f"iterations equal on {int(same.sum())}/{BATCH // 4}, max |dt| "
                     f"{float(moved[same].max()):.3e} m on those, {float(moved.max()):.3e} m over "
                     "all")
    saved.update(lanes_iters=want.iteration_count.cpu().numpy(),
                 lanes_rot=want.transform.rotation.cpu().numpy(),
                 lanes_trans=want.transform.translation.cpu().numpy())

    # Big cloud on the queen pair against the card's method iterate.
    qa, qb = _queen_points(torch, icp, dev)
    ones = torch.ones(qa.shape[0], dtype=torch.bool, device=dev)
    start_sq = pallas_nn.nearest_neighbors_pallas(qa, qb, ones)[0]
    trimmed = float((torch.sqrt(torch.sqrt(start_sq)) > BIG_CLOUD_GATE).double().mean())
    _say("parallel", f"big cloud gate {BIG_CLOUD_GATE}: trims {trimmed:.2%} of the queen matches "
                     "at the start")
    if not trimmed > 0:
        raise AssertionError(f"the gate {BIG_CLOUD_GATE} trims no queen match")
    for gate in (None, BIG_CLOUD_GATE):
        label = "ungated" if gate is None else f"gated {gate}"
        results = {}
        for mode in ("gather", "ring"):
            def run(mode=mode, gate=gate):
                return par.big_cloud_converge(
                    qa, ones, qb, ones, icp.identity(3, dtype=torch.float32, device=dev), mesh,
                    max_iterations=BIG_CLOUD_ITERATIONS, max_distance=gate, solver="svd",
                    target_mode=mode)
            results[mode], paths[f"big cloud {mode} {label}"] = _counted(torch, run)
            t = _interleaved(torch, {mode: run})[mode]
            results[mode] += (float(np.median(t)) * 1e3 / BIG_CLOUD_ITERATIONS,)
        (tf, its, mean_nn, ms_g), (tf_r, its_r, nn_r, ms_r) = results["gather"], results["ring"]
        if not (its == its_r == BIG_CLOUD_ITERATIONS and torch.equal(tf.rotation, tf_r.rotation)
                and torch.equal(tf.translation, tf_r.translation) and torch.equal(mean_nn, nn_r)):
            raise AssertionError(f"big cloud {label}: ring differs from gather at world size 1")
        twin = _big_cloud_method(icp, gate)
        state = twin.init(icp.from_points(qa.cpu().numpy(), dtype=torch.float32, device=dev),
                          icp.from_points(qb.cpu().numpy(), dtype=torch.float32, device=dev),
                          icp.identity(3, dtype=torch.float32, device=dev))
        for _ in range(BIG_CLOUD_ITERATIONS):
            state = twin.iterate(state)
        dt = _max_diff(tf.translation, state.transform.translation)
        dr = _max_diff(tf.rotation, state.transform.rotation)
        _say("parallel", f"big cloud queen (10,720 points) {label}, {BIG_CLOUD_ITERATIONS} "
                         f"iterations svd: gather {ms_g:.3f} ms/iteration, ring {ms_r:.3f} "
                         f"(bit-equal); against the card's {twin.name} 3D iterate max |dt| "
                         f"{dt:.3e} m, |dR| {dr:.3e} (bound {FLOAT32_ROUNDING:g}); launches "
                         f"{paths[f'big cloud gather {label}']} / "
                         f"{paths[f'big cloud ring {label}']}" + lap())
        if not (dt <= FLOAT32_ROUNDING and dr <= FLOAT32_ROUNDING):
            raise AssertionError(f"big cloud {label}: beyond float32 rounding of the method")
        key = "ungated" if gate is None else "gated"
        saved.update({f"big_{key}_trans": tf.translation.cpu().numpy(),
                      f"big_{key}_rot": tf.rotation.cpu().numpy()})

    # The NN merges at the queen shape against K2 on the whole target.
    k2 = pallas_nn.nearest_neighbors_pallas(qa, qb, ones)
    for name, fn in (("sharded_nn", par.sharded_nearest_neighbors),
                     ("ring_nn", par.ring_nearest_neighbors)):
        (sq, idx), paths[f"{name} queen"] = _counted(torch, lambda fn=fn: fn(qa, qb, ones, mesh))
        if not (torch.equal(sq, k2[0]) and torch.equal(idx, k2[1])):
            raise AssertionError(f"{name}: differs from K2")
    _say("parallel", f"sharded_nn and ring_nn at (10720, 10720, 3): idx and sq equal to K2; "
                     f"launches {paths['sharded_nn queen']} / {paths['ring_nn queen']}" + lap())

    # m3500 through shard_over_edges + PCG against the unsharded solve.
    name, iters, cg, bound = next(c for c in G2O_CELLS if c[0] == "m3500")
    graph = icp.io.read_g2o(os.path.join(REPO, MANHATTAN, f"{name}.g2o"), device=dev)
    sharded = pose_graph.shard_over_edges(graph, mesh)
    solves = {"unsharded": lambda: pose_graph.optimize(graph, iterations=iters, solver="pcg",
                                                       cg_iterations=cg),
              "edge-sharded": lambda: pose_graph.optimize(sharded, iterations=iters,
                                                          solver="pcg", cg_iterations=cg)}
    # The counted solves are the warm-up; three timed rounds follow.
    out = {k: _counted(torch, run) for k, run in solves.items()}
    paths["edge-sharded pcg m3500"] = out["edge-sharded"][1]
    (opt, costs), (opt_s, costs_s) = out["unsharded"][0], out["edge-sharded"][0]
    times, again = {k: [] for k in solves}, []
    for _ in range(3):
        for k, run in solves.items():
            t1 = time.perf_counter()
            result = run()
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - t1)
            if k == "unsharded":
                again.append(result[0])
    dt = _max_diff(opt_s.poses.translation, opt.poses.translation)
    repeat = _max_diff(again[0].poses.translation, opt.poses.translation)
    chi0, chi = float(costs_s[0]), float(costs_s[-1])
    _say("parallel", f"m3500 pcg {iters} x {cg} edge-sharded (1 rank): chi2 {chi0:.6g} -> "
                     f"{chi:.6g} (unsharded {float(costs[-1]):.6g}); max |dt| {dt:.3e} m from "
                     f"the unsharded solve (gate {POSE_AGREEMENT_TOL_M}; two unsharded solves "
                     f"differ by {repeat:.3e}, index_add_ order); ms per GN iteration "
                     "(median of 3 interleaved solves; each solve's) "
                     + ", ".join(f"{k} {float(np.median(t)) * 1e3 / iters:.2f} ("
                                 + ", ".join(f"{x * 1e3 / iters:.2f}" for x in t) + ")"
                                 for k, t in times.items()) + lap())
    if not (dt <= POSE_AGREEMENT_TOL_M and chi < G2O_DROP[name] * chi0
            and chi < bound * graph.num_edges):
        raise AssertionError(f"edge-sharded m3500 missed its gates: {dt}, {chi0} -> {chi}")
    # Every path but the pose graph's runs its kernel (the graph has none).
    for path, cell in paths.items():
        need = [k for prefix, kernels in PARALLEL_KERNELS.items() if path.startswith(prefix)
                for k in kernels]
        if any(cell[k] <= 0 for k in need):
            raise AssertionError(f"{path} did not launch {need}: {cell}")
    np.savez(os.path.join(out_dir, "world1.npz"), **saved)
    torch.distributed.destroy_process_group()
    print(json.dumps(paths), flush=True)


def _wait_for(path: str, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.05)


def _parallel_gloo(rank: int, out_dir: str, port: str) -> None:
    """Phase 13b, one of PARALLEL_RANKS gloo ranks on the one card: set up,
    wait for 13a, then the NN merges (ties too), big cloud over 4 point
    blocks and the lanes over 4 data ranks against 13a."""
    import numpy as np
    import torch

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(rank),
                      WORLD_SIZE=str(PARALLEL_RANKS))
    torch.cuda.set_device(0)
    sys.path.insert(0, REPO)
    import icp_tpu_torch as icp
    from icp_tpu_torch import parallel as par
    from icp_tpu_torch.ops import pallas_nn

    dev = torch.device("cuda", 0)
    par.initialize_multihost(backend="gloo", timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT_S))
    points = par.make_mesh(data=1, points=PARALLEL_RANKS)
    data = par.make_mesh(data=PARALLEL_RANKS, points=1)
    group = par.mesh.axis_group(points, par.POINT_AXIS)
    blocks = par.Layout(points, (par.POINT_AXIS,))
    qa, qb = _queen_points(torch, icp, dev)
    ones = torch.ones(qa.shape[0], dtype=torch.bool, device=dev)
    source, target, guess, method, cfg = _phase4_inputs(torch, np, icp, dev)[1]
    lines = [f"backends: points {torch.distributed.get_backend(group)}, data "
             f"{torch.distributed.get_backend(par.mesh.axis_group(data, par.DATA_AXIS))}"]
    torch.cuda.synchronize()
    open(os.path.join(out_dir, f"ready{rank}"), "w").close()  # 13a starts timing
    _wait_for(os.path.join(out_dir, "go"), PARALLEL_TIMEOUT_S)
    t0 = time.perf_counter()
    with np.load(os.path.join(out_dir, "world1.npz")) as f:
        world1 = dict(f)

    # Ties: every target row appears once in each of the four blocks.
    tied = qb[: qb.shape[0] // PARALLEL_RANKS].repeat(PARALLEL_RANKS, 1)
    for label, tgt in (("queen", qb), ("ties", tied)):
        want = pallas_nn.nearest_neighbors_pallas(qa, tgt, ones)
        t_blk, m_blk = par.local_block(tgt, blocks), par.local_block(ones, blocks)
        got_s = par.sharded_nearest_neighbors(qa, t_blk, m_blk, points)
        got_r = par.ring_nearest_neighbors(par.local_block(qa, blocks), t_blk, m_blk, points)
        got_r = tuple(par.comm.all_gather(x, group) for x in got_r)
        for name, (sq, idx) in (("sharded_nn", got_s), ("ring_nn", got_r)):
            if not (torch.equal(sq, want[0]) and torch.equal(idx, want[1])):
                raise AssertionError(f"{name} {label} over {PARALLEL_RANKS} blocks differs from K2")
        if label == "ties" and int(want[1].max()) >= tgt.shape[0] // PARALLEL_RANKS:
            raise AssertionError("ties: a later block's copy won")
    lines.append(f"sharded_nn and ring_nn with the queen targets in {PARALLEL_RANKS} blocks, "
                 "and with every target in each block (ties): idx and sq equal to K2 on the "
                 "whole target, the first block's copy wins the ties")

    a_blk, b_blk = par.local_block(qa, blocks), par.local_block(qb, blocks)
    m_blk = par.local_block(ones, blocks)
    for mode in ("gather", "ring"):
        tf, its, _ = par.big_cloud_converge(
            a_blk, m_blk, b_blk, m_blk, icp.identity(3, dtype=torch.float32, device=dev), points,
            max_iterations=BIG_CLOUD_ITERATIONS, solver="svd", target_mode=mode)
        dt = _max_diff(tf.translation, torch.as_tensor(world1["big_ungated_trans"]))
        dr = _max_diff(tf.rotation, torch.as_tensor(world1["big_ungated_rot"]))
        lines.append(f"big cloud {mode} over {PARALLEL_RANKS} point blocks: max |dt| {dt:.3e} m, "
                     f"|dR| {dr:.3e} from 13a (bound {FLOAT32_ROUNDING:g})")
        if not (its == BIG_CLOUD_ITERATIONS and dt <= FLOAT32_ROUNDING and dr <= FLOAT32_ROUNDING):
            raise AssertionError(f"big cloud {mode} over {PARALLEL_RANKS} blocks: {dt}, {dr}")

    # The lanes over 4 data ranks.  Each rank's lanes are one converge batch
    # of BATCH / 4: the gate is that batch's unsharded converge, bit for
    # bit, gathered from every rank.  Against 13a's one batch of BATCH the
    # float32 sums run in a batch-size-dependent order (cuBLAS' batched GEMM
    # and the reduce kernels pick their split by batch; 13a shows converge
    # itself moving so), so lanes are held there to float32's limits only:
    # the pose gate where the lane stops on the same iteration, the driver's
    # translation tolerance (the size of one last step) where it does not.
    fn = par.make_sharded_converge_fn(method, cfg, data)
    lanes = par.shard_batch((source, target, guess), data)
    result, _ = fn(*lanes)
    alone, _ = icp.converge(method, *lanes, cfg)
    data_group = par.mesh.axis_group(data, par.DATA_AXIS)
    exact = all(torch.equal(x, par.comm.all_gather(y, data_group)) for x, y in (
        (result.iteration_count, alone.iteration_count),
        (result.transform.rotation, alone.transform.rotation),
        (result.transform.translation, alone.transform.translation)))
    got = result.transform.translation.cpu().numpy()
    dt = np.linalg.norm(got - world1["lanes_trans"], axis=-1)
    same = result.iteration_count.cpu().numpy() == world1["lanes_iters"]
    lines.append(f"scan1 trimmed B={BATCH} over {PARALLEL_RANKS} data ranks: iterations and poses "
                 f"bit-equal to converge on each rank's {BATCH // PARALLEL_RANKS} lanes as one "
                 f"batch: {exact}; against 13a's batch of {BATCH}: iterations equal on "
                 f"{int(same.sum())}/{BATCH} lanes, max |dt| {dt[same].max():.3e} m on those "
                 f"(gate {POSE_AGREEMENT_TOL_M}), {dt.max():.3e} m over all (gate "
                 f"{cfg.translation_tolerance})")
    if not (exact and dt[same].max() <= POSE_AGREEMENT_TOL_M
            and dt.max() <= cfg.translation_tolerance):
        raise AssertionError(f"data-sharded lanes: exact {exact}, {dt[same].max()}, {dt.max()} m")
    lines.append(f"{time.perf_counter() - t0:.2f} s after the release (four processes share one "
                 "card: this measures nothing about scaling)")
    torch.distributed.destroy_process_group()
    if rank == 0:
        print(json.dumps(lines), flush=True)


def _phase_parallel(refs) -> dict:
    """Phase 13: start 13b's ranks, run 13a, gate 13a's big cloud against
    the CPU float64 runs, release 13b and read it.  Returns 13a's paths'
    launches."""
    os.makedirs(PARALLEL_DIR, exist_ok=True)
    for name in ("go", "world1.npz", *(f"ready{r}" for r in range(PARALLEL_RANKS))):
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(PARALLEL_DIR, name))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    logs = [open(os.path.join(PARALLEL_DIR, f"gloo{r}.log"), "w+") for r in range(PARALLEL_RANKS)]
    ranks = [subprocess.Popen([sys.executable, __file__, "--parallel-gloo", str(r), PARALLEL_DIR,
                               port], stdout=logs[r], stderr=subprocess.STDOUT, cwd=REPO)
             for r in range(PARALLEL_RANKS)]
    try:
        t0 = time.perf_counter()
        world1 = subprocess.run([sys.executable, __file__, "--parallel-world1", PARALLEL_DIR],
                                capture_output=True, text=True, timeout=PARALLEL_TIMEOUT_S,
                                cwd=REPO)
        if world1.returncode != 0:
            failed = []
            for r, proc in enumerate(ranks):
                if proc.poll() not in (None, 0):
                    logs[r].seek(0)
                    failed.append(f"13b rank {r} exited {proc.returncode}:\n"
                                  f"{logs[r].read()[-3000:]}")
            raise AssertionError(f"phase 13a failed:\n{world1.stdout[-3000:]}\n"
                                 f"{world1.stderr[-3000:]}\n" + "\n".join(failed))
        out = world1.stdout.strip().splitlines()
        for line in out[:-1]:
            print(line, flush=True)
        paths = json.loads(out[-1])
        import numpy as np

        with np.load(os.path.join(PARALLEL_DIR, "world1.npz")) as f:
            card = dict(f)
        for key, gate in (("ungated", None), ("gated", BIG_CLOUD_GATE)):
            cpu = refs[f"phase13 {key}"].get()
            dt = float(np.abs(card[f"big_{key}_trans"] - cpu["translation"]).max())
            _say("parallel", f"big cloud {key}: max |dt| {dt:.3e} m from the CPU float64 "
                             f"method iterate (gate {POSE_AGREEMENT_TOL_M})")
            if not dt <= POSE_AGREEMENT_TOL_M:
                raise AssertionError(f"big cloud {key}: {dt} m from CPU float64")
        _say("parallel", f"13a {time.perf_counter() - t0:.2f} s")
        open(os.path.join(PARALLEL_DIR, "go"), "w").close()
        t0 = time.perf_counter()
        for r, proc in enumerate(ranks):
            code = proc.wait(timeout=PARALLEL_TIMEOUT_S)
            if code != 0:
                logs[r].seek(0)
                raise AssertionError(f"phase 13b rank {r} exited {code}:\n{logs[r].read()[-3000:]}")
        logs[0].seek(0)
        for line in json.loads(logs[0].read().strip().splitlines()[-1]):
            _say("parallel-gloo", line)
        _say("parallel", f"13b {time.perf_counter() - t0:.2f} s after the release")
    finally:
        for proc in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    return paths


def main() -> int:
    import multiprocessing

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    sys.path.insert(0, REPO)
    import icp_tpu_torch  # noqa: F401  (fails here without the program)
    from icp_tpu_torch.utils import native

    # The native CSV loader, built once here (g++) before any worker could
    # race to build it: phase 12b reads whether it was in the checkout.
    native_had = os.path.exists(native._lib_path())
    t0 = time.perf_counter()
    native.native_lib()
    native_build = (native_had, time.perf_counter() - t0)

    # The workers run at the lowest priority, so that the host-bound timings
    # of phases 3-9 keep the cores they need.
    context = multiprocessing.get_context("spawn")
    pool = context.Pool(REFERENCE_WORKERS, initializer=os.nice, initargs=(19,))
    # Phase 11's CPU streams take minutes each: a pool of their own (one
    # thread a worker), so that phases 9 and 10 never wait behind them.
    slam_pool = context.Pool(3, initializer=os.nice, initargs=(19,))
    # Phase 12a's pinned streams: two processes on the card, at the normal
    # priority, run beside the untimed rest of phases 11 and 12.
    card_pool = context.Pool(len(SLAM_MODES))
    try:
        # Phase 6's CPU runs first: phase 6 reads them within a minute.
        refs = {f"3d {name}": pool.apply_async(_phase6_reference, (name,))
                for name, _ in QUEEN_METHODS}
        refs.update({task: pool.apply_async(_phase9_reference, (task,))
                     for task in REFERENCE_TASKS})
        for name, *_ in G2O_CELLS:
            for dtype in ("float64", "float32"):
                refs[f"g2o {name} {dtype}"] = pool.apply_async(
                    _phase10_reference, ("g2o", (name, dtype)))
        for key, gate in (("ungated", None), ("gated", BIG_CLOUD_GATE)):
            refs[f"phase13 {key}"] = pool.apply_async(_phase13_reference, (gate,))
        slam_refs = {(mode, "float64"): slam_pool.apply_async(_phase11_reference,
                                                               (mode, "float64"))
                     for mode in SLAM_MODES}
        # The float32 runs are read only where the card misses the gate; the
        # pipelined stream does (float32 does not determine it to the
        # gate), so its first float32 run is queued now, the others when a
        # miss needs them.
        slam_refs["pipelined", "float32", 0] = slam_pool.apply_async(
            _phase11_reference, ("pipelined", "float32"))
        # Phase 12a's float32 rule reads the pinned pipelined stream's twin.
        slam_refs["pipelined", "float32", 0, "pinned"] = slam_pool.apply_async(
            _phase11_reference, ("pipelined", "float32", 0, "pinned"))
        return _phases(refs, pool, (slam_pool, slam_refs), card_pool, native_build)
    finally:
        for p in (pool, slam_pool, card_pool):
            p.terminate()
            p.join()


def _phases(refs, pool, slam_refs, card_pool, native_build) -> int:
    import numpy as np
    import torch

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
    (a_pts, b_pts, angles, shifts), (source, target, guess, method, cfg) = _phase4_inputs(
        torch, np, icp, dev)

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

    trace, (main_device, main_host) = _trace(torch, run, events=True)
    _say("trace", trace)
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
    del result, rot, trans  # source and target stay for phase 12c's trace of run()
    torch.cuda.empty_cache()
    phase_done("5 pose")

    # Phase 6: the 3D path; phase 7: the 2D method matrix.
    paths = {"trimmed_2d_multiscale": launches}
    for name, cell in _phase_3d(torch, np, icp, dev, refs).items():
        paths[f"{name}_3d"] = cell
    phase_done("6 3d path")
    for name, cell in _phase_matrix(torch, np, icp, dev).items():
        paths[f"matrix {name}"] = cell
    phase_done("7 matrix")
    paths.update(_phase_families(torch, np, icp, dev))
    phase_done("8 families")
    paths.update(_phase_front_end(torch, np, icp, dev, refs))
    phase_done("9 front end")
    back_paths, closure_err, closure_label = _phase_back_end(torch, np, icp, dev, refs, pool)
    paths.update(back_paths)
    for k in errs:
        errs[k] = max(errs[k], closure_err)
    exact_cases.append(closure_label)
    phase_done("10 back end")
    paths.update(_phase_slam_surfaces(torch, np, icp, dev, slam_refs, card_pool, run,
                                      (main_device, main_host, launches), timed["fine"],
                                      native_build))
    phase_done("11-12 slam and surfaces")
    paths.update(_phase_parallel(refs))
    phase_done("13 parallel")
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
    # Phase 13's own processes (the script itself takes no arguments).
    if sys.argv[1:2] == ["--parallel-world1"]:
        _parallel_world1(sys.argv[2])
    elif sys.argv[1:2] == ["--parallel-gloo"]:
        _parallel_gloo(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        sys.exit(main())
