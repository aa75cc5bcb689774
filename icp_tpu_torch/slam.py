"""SLAM pipelines: one-call offline (:func:`run_slam`) and incremental
online (:class:`OnlineSlam`).

Port of :mod:`icp_tpu.slam`.  Offline: odometry, loop-closure detection
(pose radius or Scan Context appearance), closure registration in one
batched converge, and a robust pose-graph solve.  Online: scans arrive one
at a time; keyframe odometry streams on the converge, closures register
every ``loop_every`` keyframes, the robust graph solve re-anchors the live
pose mid-stream, and the whole streaming state checkpoints for an exact
resume (:func:`icp_tpu_torch.resilient.resumable_online_slam`).  Also the
multi-session merge (:func:`merge_sessions`) and global relocalization
(:func:`relocalize`).

The session lives on one device (``device="cuda"`` by default; without a
card it raises unless ``device="cpu"``); scans on another device are
refused.  The pipelined mode's cost-anomaly retry is decided as in the JAX
package, but its predicate is read on the host (one sync), and the retry
converge runs only when it holds.

``async_refine=True`` takes the graph solve off the ``add_scan`` path: the
session builds the graph on its own thread and hands the solve to a
single worker thread (on the card, on a CUDA stream of its own); the first
``add_scan`` after the solve has finished applies it by the exact
left-compose correction.  On the card a solve has finished when the worker
has returned and the event it records after the solve's kernels has
completed (JAX's ``Array.is_ready()``), so an apply never queues the
session's next scan behind the solve's kernels.

Not ported (each only shared compiled XLA executables, and none changes a
result: ``converge`` freezes each lane separately, and padded nodes and
edges are inert): the lru-cached converge / device-step / graph-solver
factories, ``prefetch_buckets``, ``aot_cache``, and ``_refine``'s node and
closure-batch bucket padding.

Four departures from the reference, all corrections of its faults:

* pipelined + ``async_refine``: a finished solve is applied before the next
  scan is launched, so its correction reaches every pose chained from the
  stale anchor (the in-flight scan, the keyframes promoted meanwhile, the
  live pose); the reference applies it after the launch and corrects only
  the previous scan (``icp_tpu/slam.py:873-898``);
* :meth:`OnlineSlam.load_state` waits out and drops an outstanding
  asynchronous solve and resets the closure-weight and robust-scale
  diagnostics of the previous session (``icp_tpu/slam.py:1024`` keeps
  them);
* a serial checkpoint loaded into a pipelined session chains from the last
  keyframe at that keyframe's pose (``icp_tpu/slam.py:1087-1096`` means to,
  but overwrites it with the live pose);
* ``mapping_kernel='gnc_gm'`` is refused when the session is built, where
  the reference fails at the first mapping-scale refinement
  (``icp_tpu/slam.py:289,445``; the fused two-pass solve's early exit does
  not support the GNC schedule).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from concurrent.futures import Future, ThreadPoolExecutor, wait

import numpy as np
import torch

from . import geometry, odometry, pose_graph
from .cloud import PointCloud
from .driver import DriverConfig, converge, make_converge_fn
from .geometry import RigidTransform
from .methods.base import Method
from .ops.descriptor import (
    descriptor_query,
    find_loop_candidates_descriptor,
    find_loop_candidates_descriptor_incremental,
    scan_context,
    yaw_seeds,
)
from .utils.profiling import nvtx_range

HIST = 16  # the cost history the anomaly retry reads


@dataclasses.dataclass(frozen=True)
class OnlineUpdate:
    """One :meth:`OnlineSlam.add_scan` result."""

    pose: RigidTransform  # live world-from-scan pose (refined frame)
    is_keyframe: bool
    refined: bool  # a loop-closure refinement ran on this scan
    num_closures: int  # accepted closures so far


def _masked_median(hist: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``np.median`` over the last ``count`` entries of ``hist`` (newest at
    the end), the even-count middle-pair mean included: the pipelined
    mode's twin of the serial path's host median."""
    n = hist.shape[0]
    valid = torch.arange(n, device=hist.device) >= n - count
    vals = torch.sort(torch.where(valid, hist, torch.full_like(hist, torch.inf))).values
    lo = vals[torch.clamp((count - 1) // 2, min=0)]
    hi = vals[torch.clamp(count // 2, min=0)]
    return 0.5 * (lo + hi)


def _online_step(fn, prev_scan: PointCloud, prev_pose: RigidTransform, scan: PointCloud,
                 hist: torch.Tensor, count: torch.Tensor, retry_factor: float):
    """One pipelined-SLAM advance: scan-to-scan registration from the
    identity, and the coarse retry when the cost is anomalous against the
    history's median (the retry converge runs only then).  Returns
    ``(pose, cost, new_hist, new_count)``.

    Scan-to-scan, not scan-to-keyframe: the pipelined dispatch cannot see
    the promotion decided for the in-flight previous scan, and adjacent
    scans are always one scan of motion apart, well inside ICP's basin."""
    from .ops.coarse import coarse_align_2d, coarse_align_3d

    def register(guess):
        result, _ = fn(prev_scan, scan, guess)
        # prev -> scan registration T: the pose advances by inv(T).
        return geometry.compose(prev_pose, geometry.inverse(result.transform)), result.cost

    pose, cost = register(geometry.identity(scan.dim, dtype=scan.dtype,
                                            device=scan.points.device))
    anomalous = (count >= 4) & (cost > retry_factor * _masked_median(hist, count))
    if bool(anomalous):
        coarse = coarse_align_2d if scan.dim == 2 else coarse_align_3d
        pose2, cost2 = register(coarse(prev_scan, scan))
        better = cost2 < cost
        pose = RigidTransform(torch.where(better, pose2.rotation, pose.rotation),
                              torch.where(better, pose2.translation, pose.translation))
        cost = torch.where(better, cost2, cost)
    new_hist = torch.cat([hist[1:], cost.reshape(1).to(hist.dtype)])
    new_count = torch.clamp(count + 1, max=hist.shape[0])
    return pose, cost, new_hist, new_count


def _assemble_graph(poses, odo, odo_w, loop_ij, loop, loop_w, loop_info):
    """The keyframe graph (odometry chain, then closures) and the robust-edge
    mask (the closures with a positive weight)."""
    graph = pose_graph.graph_from_trajectory(
        poses, odo, loop_edges=loop_ij, loop_measurements=loop,
        odometry_weight=odo_w, loop_weight=loop_w, loop_information=loop_info)
    mask = torch.cat([torch.zeros(odo_w.shape, dtype=torch.bool, device=odo_w.device),
                      loop_w > 0])
    return graph, mask


def _associative_scan(combine, elems):
    """Inclusive prefix scan along axis 0 by ``jax.lax.associative_scan``'s
    recursion (pairs, the odd prefixes recursively, then the even ones), so
    the products associate as in the JAX package."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = _associative_scan(combine, combine([e[0:-1:2] for e in elems],
                                             [e[1::2] for e in elems]))
    tail = [e[2::2] for e in elems]
    even = combine([e[:-1] for e in odd] if n % 2 == 0 else odd, tail)
    even = [torch.cat([e[:1], r]) for e, r in zip(elems, even)]
    out = []
    for a, b in zip(even, odd):
        merged = torch.empty((a.shape[0] + b.shape[0], *a.shape[1:]), dtype=a.dtype,
                             device=a.device)
        merged[0::2], merged[1::2] = a, b
        out.append(merged)
    return out


def _chain_init(poses: RigidTransform, odo: RigidTransform) -> RigidTransform:
    """Absolute poses from the odometry chain: ``X_0`` = the first
    keyframe's current pose (the gauge), ``X_{i+1} = X_i ∘ Z_i``, projected
    onto SO(D) (a long float32 product contracts)."""

    def combine(a, b):
        (ra, ta), (rb, tb) = a, b
        return [torch.matmul(ra, rb), torch.matmul(ra, tb[..., None])[..., 0] + ta]

    rots = torch.cat([poses.rotation[:1], odo.rotation])
    trans = torch.cat([poses.translation[:1], odo.translation])
    pr, pt = _associative_scan(combine, [rots, trans])
    return RigidTransform(geometry.project_rotation(pr), pt)


def _solve_single(graph, mask, robust, robust_scale, iterations, solver):
    """Single-pass solve: ``(poses, edge weights, scale)``."""
    dtype, device = graph.weights.dtype, graph.weights.device
    if robust == "none":
        g, _ = pose_graph.optimize(graph, iterations=iterations, solver=solver)
        return (g.poses, torch.ones((graph.num_edges,), dtype=dtype, device=device),
                torch.tensor(1.0, dtype=dtype, device=device))
    # Resolving 'auto' here is optimize's own call, and hands the scale to
    # the weights diagnostic without a second solve.
    if isinstance(robust_scale, str):
        scale = pose_graph.auto_robust_scale(graph, iterations=iterations, solver=solver,
                                             robust_edges=mask)
    else:
        scale = torch.as_tensor(robust_scale, dtype=dtype, device=device)
    g, _ = pose_graph.optimize(graph, iterations=iterations, solver=solver, robust=robust,
                               robust_scale=scale, robust_edges=mask)
    w, _ = pose_graph.robust_edge_weights(g, robust, scale, robust_edges=mask)
    return g.poses, w, scale


def _solve_two_pass(graph, mask, odo, kernel, robust_scale, passes, iterations, solver):
    """Two-pass fused solve from the cold odometry-chain init:
    ``(poses, edge weights, scale)``.  A warm start can sit in a basin an
    outlier cluster bent, and at already-refined poses every scale
    statistic is at the noise floor, so that the re-estimate would reject
    true closures."""
    graph = dataclasses.replace(graph, poses=_chain_init(graph.poses, odo))
    g, _, scale, w = pose_graph.robust_solve_fused(
        graph, mask, kernel=kernel, iterations=iterations, solver=solver,
        robust_scale=robust_scale, scale_passes=passes, early_exit_tol=1e-6)
    return g.poses, w, scale


def _solve_job(solve, k: int, n_loop: int, stream, events):
    """The asynchronous refinement's worker: ``solve()`` on ``stream`` (the
    session's solve stream on the card, None on the CPU) between the two
    CUDA ``events`` (start, end; None on the CPU), then the slices the apply
    needs, ``(poses[:k], closure weights, scale, k)``.  It reads only its
    arguments and touches no session state."""
    dev = None if stream is None else stream.device
    ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
    with ctx, nvtx_range("slam.refine.solve", dev or "cpu"):
        if events is not None:
            events[0].record(stream)
        poses, w, scale = solve()
        out = (RigidTransform(poses.rotation[:k], poses.translation[:k]),
               w[k - 1:k - 1 + n_loop], scale, k)
        if events is not None:
            events[1].record(stream)
        return out


@dataclasses.dataclass
class _AsyncSolve:
    """An outstanding asynchronous refinement: the worker's future, the
    graph it reads (kept referenced until the apply, so that the caching
    allocator cannot hand its memory to the session's stream meanwhile) and,
    on the card, the CUDA events recorded around the solve's kernels."""

    future: Future
    inputs: tuple
    events: tuple | None = None

    def ready(self) -> bool:
        """The worker has returned and, on the card, the solve's kernels
        have completed."""
        return self.future.done() and (self.events is None or self.events[1].query())

    def block_until_ready(self) -> None:
        """Wait until :meth:`ready` (``jax.block_until_ready``); a failure in
        the worker raises here."""
        self.future.result()
        if self.events is not None:
            self.events[1].synchronize()


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class OnlineSlam:
    """Incremental SLAM: streaming odometry + periodic robust loop closure.

    Each scan registers against the current keyframe
    (:func:`icp_tpu_torch.odometry.stream_step`); keyframes accumulate; every
    ``loop_every`` keyframes the back end finds revisits (``loop_detector``
    ``'radius'`` among the keyframe poses, or ``'descriptor'``: Scan Context
    retrieval, which does not trust the drifted poses), registers the fresh
    candidate pairs in one batched converge, re-solves the keyframe graph
    with the robust kernel, and re-anchors the live pose.  Below
    ``mapping_threshold`` accepted closures the single-pass ``robust``
    kernel down-weights wrong closures; from there on
    (``scale_passes='auto'``) the two-pass ``mapping_kernel`` solve of
    :func:`icp_tpu_torch.pose_graph.robust_solve_fused` takes over.

    ``pipelined=True``: scan t + 1's scan-to-scan step is launched before
    scan t's promotion predicate is read, updates return one scan late
    (:meth:`flush` drains the last), and a refinement that lands while a
    scan is in flight re-anchors it exactly (left-composed correction).

    ``async_refine=True``: a refinement registers its closures and builds
    the graph as usual, then hands the solve to the session's worker thread
    (on the card, a CUDA stream of its own that waits for the graph) and
    returns; scans go on chaining from the stale keyframe.  The first
    ``add_scan`` after the solve has finished applies it: the solved poses
    replace the snapshot's keyframes, and ``C = new_anchor ∘ old_anchor⁻¹``
    is left-composed onto every pose chained from the stale anchor since
    (keyframes promoted meanwhile, the live pose, and in pipelined mode the
    scans in flight), which equals the synchronous re-anchor up to roundoff.
    A refinement due while a solve is outstanding is deferred to the next
    refinement cycle.  A failure in the worker is raised by the apply.
    :meth:`state_dict`, :meth:`finalize` and :func:`merge_sessions` apply
    an outstanding solve first.

    The weights approximate information (1/sigma²): a stiff odometry chain
    (``odometry_weight``) is what lets the robust kernel reject a wrong
    closure instead of bending the chain.  Not thread-safe.
    """

    def __init__(
        self,
        method: Method,
        config: DriverConfig,
        *,
        translation_threshold: float = 0.5,
        angle_threshold: float = 0.1,
        loop_every: int = 8,
        loop_radius: float = 2.0,
        loop_detector: str = "radius",
        descriptor_range: float | None = None,
        descriptor_max_distance: float = 0.2,
        loop_min_separation: int = 10,
        loop_max_candidates: int = 16,
        loop_max_cost: float | None = None,
        loop_coarse: bool = False,
        loop_weight: float = 10.0,
        odometry_weight: float = 1.0,
        robust: str = "gnc_gm",
        robust_scale: float | str = "auto",
        scale_passes: int | str = "auto",
        mapping_kernel: str = "welsch",
        mapping_threshold: int = 12,
        gn_iterations: int | None = None,
        gn_solver: str = "dense",
        closure_information: bool = False,
        information_neighbors: int = 10,
        pipelined: bool = False,
        async_refine: bool = False,
        device="cuda",
    ):
        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("OnlineSlam: device 'cuda' needs a CUDA card "
                               "(pass device='cpu' to run on the host)")
        if loop_detector not in ("radius", "descriptor"):
            raise ValueError(
                f"loop_detector must be 'radius' or 'descriptor', got {loop_detector!r}")
        if loop_detector == "descriptor" and descriptor_range is None:
            raise ValueError("loop_detector='descriptor' needs descriptor_range (sensor range)")
        if isinstance(scale_passes, str) and scale_passes != "auto":
            raise ValueError(f"scale_passes must be an int or 'auto', got {scale_passes!r}")
        if mapping_kernel == "gnc_gm" and robust != "none" and scale_passes != 1:
            raise ValueError(
                "mapping_kernel='gnc_gm' is not supported: the two-pass mapping-scale "
                "solve exits early, which the GNC schedule does not allow; use 'welsch' "
                "(or scale_passes=1)")
        self._method = method
        self._config = config
        self._fn = make_converge_fn(method, config)
        self._tt = translation_threshold
        self._ta = angle_threshold
        self._loop_every = loop_every
        self._loop_radius = loop_radius
        self._loop_detector = loop_detector
        self._desc_range = descriptor_range
        self._desc_max_dist = descriptor_max_distance
        self._kf_descs: list[torch.Tensor] = []  # one Scan Context per keyframe
        self._desc_queried = 0  # keyframes already scored for candidates
        self._loop_min_sep = loop_min_separation
        self._loop_max_cands = loop_max_candidates
        self._loop_max_cost = loop_max_cost
        # Seed closures from the global coarse initializer instead of the
        # current pose estimates (for relative drift beyond the basin).
        self._loop_coarse = loop_coarse
        self._loop_weight = loop_weight
        self._odometry_weight = odometry_weight
        self._robust = robust
        self._robust_scale = robust_scale
        self._scale_passes = scale_passes
        self._mapping_kernel = mapping_kernel
        self._mapping_threshold = mapping_threshold
        self._gn_iterations = gn_iterations or (30 if robust != "none" else 10)
        self._gn_solver = gn_solver
        self._closure_information = closure_information
        self._information_neighbors = information_neighbors
        self._pipelined = pipelined

        # Keyframe poses, odometry and closure measurements and keyframe
        # clouds: stacked tensors plus pending lists, folded with one
        # concatenate per refinement (the hot path only appends).
        self._kf_clouds: list[PointCloud] = []
        self._kf_poses: RigidTransform | None = None
        self._kf_pending: list[RigidTransform] = []
        self._odo_meas: list[RigidTransform] = []  # pending, measured at promotion
        self._odo_stack: RigidTransform | None = None
        self._loop_stack: RigidTransform | None = None
        self._kf_cloud_stack: PointCloud | None = None
        self._kf_cloud_folded = 0
        # Per-odometry-edge weight multipliers (x odometry_weight): 1 for a
        # registration; merge_sessions' bridge link is 1e-3.
        self._odo_weight_scale: list[float] = []
        self._loop_edges: list[tuple[int, int]] = []
        self._loop_meas: list[RigidTransform] = []
        self._tried_pairs: set[tuple[int, int]] = set()
        self._kf_since_refine = 0
        self._cur_kf_pose: RigidTransform | None = None
        self._pose: RigidTransform | None = None
        self._cost_hist: list[float] = []
        self._retry_factor = 5.0  # cost anomaly threshold vs the recent median
        # Pipelined mode: the in-flight (scan, pose), the last launched scan,
        # the cost ring on the device, and a refinement's correction for the
        # in-flight scan.
        self._pending = None
        self._prev_scan: PointCloud | None = None
        self._hist: torch.Tensor | None = None
        self._hist_count: torch.Tensor | None = None
        self._correction: RigidTransform | None = None
        self._closure_weights_dev: torch.Tensor | None = None
        self._robust_scale_used: torch.Tensor | None = None
        # Asynchronous refinement: the outstanding solve, the worker (one
        # thread, made at the first dispatch) and, on the card, its stream.
        # ``_in_flight`` is set while a launched scan is not yet pending
        # (inside _add_scan_pipelined's materialize).
        self._async_refine = async_refine
        self._async_solve: _AsyncSolve | None = None
        # On the card, the (start, end) CUDA events of each applied solve:
        # the worker's device time per solve.
        self._solve_events: list[tuple] = []
        self._executor: ThreadPoolExecutor | None = None
        self._solve_stream = None
        self._in_flight = False

    # -- public API ---------------------------------------------------------

    @staticmethod
    def _fold(stack: RigidTransform | None, pending: list) -> RigidTransform | None:
        """Fold a pending list of transforms into the stack (one stack and
        one concatenate)."""
        if not pending:
            return stack
        pend_r = torch.stack([p.rotation for p in pending])
        pend_t = torch.stack([p.translation for p in pending])
        if stack is None:
            return RigidTransform(pend_r, pend_t)
        return RigidTransform(torch.cat([stack.rotation, pend_r]),
                              torch.cat([stack.translation, pend_t]))

    @property
    def keyframe_poses(self) -> RigidTransform:
        """Current (refined) keyframe trajectory, stacked ``(K, ...)``."""
        self._kf_poses = self._fold(self._kf_poses, self._kf_pending)
        self._kf_pending = []
        if self._kf_poses is None:
            raise ValueError("no keyframes yet")
        return self._kf_poses

    def _folded_odo(self) -> RigidTransform | None:
        self._odo_stack = self._fold(self._odo_stack, self._odo_meas)
        self._odo_meas = []
        return self._odo_stack

    def _folded_loop(self) -> RigidTransform | None:
        """Accepted-closure measurements as one ``(L, ...)`` stack; pending
        entries are batches (a refinement's accepted rows) or single
        transforms."""
        if self._loop_meas:
            parts_r, parts_t = [], []
            if self._loop_stack is not None:
                parts_r.append(self._loop_stack.rotation)
                parts_t.append(self._loop_stack.translation)
            for m in self._loop_meas:
                batched = m.rotation.dim() == 3
                parts_r.append(m.rotation if batched else m.rotation[None])
                parts_t.append(m.translation if batched else m.translation[None])
            self._loop_stack = RigidTransform(torch.cat(parts_r), torch.cat(parts_t))
            self._loop_meas = []
        return self._loop_stack

    def _folded_clouds(self) -> PointCloud:
        """Keyframe clouds as one stacked ``(k, N, D)`` cloud."""
        k = len(self._kf_clouds)
        if self._kf_cloud_folded < k:
            fresh = self._kf_clouds[self._kf_cloud_folded:]
            pts = torch.stack([c.points for c in fresh])
            cnt = torch.stack([c.count for c in fresh])
            if self._kf_cloud_stack is not None:
                pts = torch.cat([self._kf_cloud_stack.points, pts])
                cnt = torch.cat([self._kf_cloud_stack.count, cnt])
            self._kf_cloud_stack = PointCloud(pts, cnt)
            self._kf_cloud_folded = k
        return self._kf_cloud_stack

    @property
    def closure_weights(self) -> np.ndarray | None:
        """The last refinement's robust IRLS weight per accepted closure (in
        the closure list's order), or None before the first solve: wrong
        closures near 0, inliers near 1."""
        if self._closure_weights_dev is None:
            return None
        return _np(self._closure_weights_dev)

    def add_scan(self, scan: PointCloud) -> OnlineUpdate | None:
        """Feed one scan.  Serial mode returns this scan's update; pipelined
        mode the previous scan's (None on the second scan), and
        :meth:`flush` drains the last."""
        if not _same_device(scan.points.device, self._device):
            raise ValueError(f"scan on {scan.points.device}, session on {self._device}")
        if self._pipelined:
            return self._add_scan_pipelined(scan)
        if not self._kf_clouds:
            self._pose = geometry.identity(scan.dim, dtype=scan.dtype, device=scan.points.device)
            self._promote(scan, self._pose)
            return OnlineUpdate(self._pose, True, False, len(self._loop_edges))
        # Register from the identity.  Seeding from the previous pose feeds
        # an unconverged step's angular error forward, and it compounds;
        # an anomalous cost instead gets one coarse-seeded retry, keeping
        # the lower cost.
        with nvtx_range("slam.register", self._device):
            pose, is_kf, result = odometry.stream_step(
                self._fn, self._kf_clouds[-1], self._cur_kf_pose, scan, self._tt, self._ta)
            cost = float(result.cost)
            hist = self._cost_hist
            if len(hist) >= 4 and cost > self._retry_factor * float(np.median(hist)):
                from .ops.coarse import coarse_align_2d, coarse_align_3d

                coarse = coarse_align_2d if scan.dim == 2 else coarse_align_3d
                seed = coarse(self._kf_clouds[-1], scan)
                pose2, is_kf2, result2 = odometry.stream_step(
                    self._fn, self._kf_clouds[-1], self._cur_kf_pose, scan, self._tt,
                    self._ta, guess=seed)
                if float(result2.cost) < cost:
                    pose, is_kf, result = pose2, is_kf2, result2
                    cost = float(result2.cost)
        hist.append(cost)
        if len(hist) > HIST:
            hist.pop(0)
        self._pose = pose
        # A finished asynchronous solve corrects the pose just chained.
        refined = self._maybe_apply_async()
        if is_kf:
            self._promote(scan, self._pose)
            self._kf_since_refine += 1
            if self._kf_since_refine >= self._loop_every:
                refined = self._refine() or refined
                self._kf_since_refine = 0
        return OnlineUpdate(self._pose, bool(is_kf), refined, len(self._loop_edges))

    def _add_scan_pipelined(self, scan: PointCloud) -> OnlineUpdate | None:
        if not self._kf_clouds:
            self._pose = geometry.identity(scan.dim, dtype=scan.dtype, device=scan.points.device)
            self._promote(scan, self._pose)
            self._prev_scan = scan
            self._hist = torch.zeros((HIST,), dtype=scan.dtype, device=scan.points.device)
            self._hist_count = torch.tensor(0, dtype=torch.int32, device=scan.points.device)
            return OnlineUpdate(self._pose, True, False, len(self._loop_edges))
        # A finished asynchronous solve is applied before the launch, so that
        # its correction reaches the scan launched now and the one in
        # flight (the reference applies it after the launch:
        # icp_tpu/slam.py:873-898).
        applied = self._maybe_apply_async()
        # Launch scan t against scan t - 1.  The in-flight previous pose is
        # in the pre-refinement frame until it materializes: bring it into
        # the refined frame first.
        if self._pending is not None:
            prev_pose = self._pending[1]
            if self._correction is not None:
                prev_pose = geometry.compose(self._correction, prev_pose)
        else:
            prev_pose = self._pose
        with nvtx_range("slam.register", self._device):
            pose, _, self._hist, self._hist_count = _online_step(
                self._fn, self._prev_scan, prev_pose, scan, self._hist, self._hist_count,
                self._retry_factor)
        self._prev_scan = scan
        update = None
        if self._pending is not None:
            # Scan t is in flight but not pending yet: a solve applied while
            # scan t - 1 materializes must correct it too.
            self._in_flight = True
            try:
                update = self._materialize_pending(applied)
            finally:
                self._in_flight = False
        self._pending = (scan, pose)
        return update

    def _materialize_pending(self, applied: bool) -> OnlineUpdate:
        """Resolve the in-flight scan: one host read of the promotion
        predicate, judged against the current keyframe pose (a stale anchor
        promotes on nearly every scan once the motion per scan passes half
        the threshold), then the serial mode's promotion and refinement.
        ``applied``: an asynchronous solve was applied for this update."""
        scan, pose = self._pending
        self._pending = None
        if self._correction is not None:
            # A refinement ran while this scan was in flight: left-compose
            # the keyframe correction.
            pose = geometry.compose(self._correction, pose)
            self._correction = None
        delta_t = torch.linalg.vector_norm(pose.translation - self._cur_kf_pose.translation)
        delta_a = geometry.rotation_angle(
            torch.matmul(pose.rotation, self._cur_kf_pose.rotation.transpose(-1, -2)))
        dt_v, da_v = _np(torch.stack([delta_t, torch.abs(delta_a)]))  # one transfer
        promoted = float(dt_v) > self._tt or float(da_v) > self._ta
        self._pose = pose
        refined = applied
        if promoted:
            self._promote(scan, pose)
            self._kf_since_refine += 1
            if self._kf_since_refine >= self._loop_every:
                old_kf = self._cur_kf_pose
                ran = self._refine()
                if ran:
                    # Re-anchor the scan still in flight too (an asynchronous
                    # refinement records its correction when it is applied).
                    self._correction = geometry.compose(self._cur_kf_pose,
                                                        geometry.inverse(old_kf))
                refined = ran or refined
                self._kf_since_refine = 0
        return OnlineUpdate(self._pose, promoted, refined, len(self._loop_edges))

    def flush(self) -> OnlineUpdate | None:
        """Pipelined mode: materialize the in-flight scan (None when nothing
        is pending)."""
        if self._pending is None:
            return None
        return self._materialize_pending(self._maybe_apply_async())

    def state_dict(self) -> dict:
        """The full streaming state as a dict of numpy arrays, the JAX
        package's keys, dtypes and shapes: the checkpoint payload.
        :meth:`load_state` continues exactly where this stopped.  Pipelined
        mode flushes the in-flight scan first (a checkpoint is a stream
        boundary); an outstanding asynchronous solve is applied."""
        if self._pipelined:
            self.flush()
        self._maybe_apply_async(force=True)
        if not self._kf_clouds:
            return {"num_keyframes": np.asarray(0)}
        poses = self.keyframe_poses
        out = {
            "num_keyframes": np.asarray(len(self._kf_clouds)),
            "kf_points": np.stack([_np(c.points) for c in self._kf_clouds]),
            "kf_counts": np.asarray([_np(c.count) for c in self._kf_clouds]),
            "kf_rot": _np(poses.rotation),
            "kf_trans": _np(poses.translation),
            "pose_rot": _np(self._pose.rotation),
            "pose_trans": _np(self._pose.translation),
            "kf_since_refine": np.asarray(self._kf_since_refine),
            "cost_hist": self._cost_hist_np(),
        }
        if self._pipelined and self._prev_scan is not None:
            # The next scan registers against the last raw scan.
            out["prev_points"] = _np(self._prev_scan.points)
            out["prev_count"] = _np(self._prev_scan.count)
        out["tried_pairs"] = np.asarray(sorted(self._tried_pairs), dtype=np.int64).reshape(-1, 2)
        out["desc_queried"] = np.asarray(self._desc_queried)
        out["loop_edges"] = np.asarray(self._loop_edges, dtype=np.int64).reshape(-1, 2)
        odo = self._folded_odo()
        if odo is not None:
            out["odo_rot"] = _np(odo.rotation)
            out["odo_trans"] = _np(odo.translation)
            out["odo_weight_scale"] = np.asarray(self._odo_weight_scale, dtype=np.float64)
        loop = self._folded_loop()
        if loop is not None and loop.rotation.shape[0] > 0:
            out["loop_rot"] = _np(loop.rotation)
            out["loop_trans"] = _np(loop.translation)
        return out

    def load_state(self, state: dict) -> None:
        """Restore :meth:`state_dict` output (the JAX package's too) onto the
        session's device.  Unlike the reference, an outstanding asynchronous
        solve is waited out and dropped, and the previous session's closure
        weights and robust scale are cleared; and a serial checkpoint loaded
        into a pipelined session chains from its last keyframe at that
        keyframe's pose (the reference keeps the live pose there,
        ``icp_tpu/slam.py:1087-1096``)."""
        self._drop_async()
        k = int(state["num_keyframes"])
        if k == 0:
            return
        dev = self._device

        def tensor(x):
            return torch.as_tensor(np.asarray(x), device=dev)

        def transform(r, t):
            return RigidTransform(tensor(r), tensor(t))

        self._kf_clouds = [PointCloud(tensor(state["kf_points"][i]),
                                      tensor(state["kf_counts"][i]).to(torch.int32))
                           for i in range(k)]
        self._kf_poses = transform(state["kf_rot"], state["kf_trans"])
        self._kf_pending = []
        self._odo_meas = []
        self._odo_stack = (transform(state["odo_rot"], state["odo_trans"])
                           if "odo_rot" in state else None)
        n_odo = 0 if self._odo_stack is None else int(state["odo_rot"].shape[0])
        self._odo_weight_scale = [
            float(x) for x in np.asarray(state.get("odo_weight_scale", np.ones(n_odo)))]
        self._loop_edges = [(int(i), int(j)) for i, j in np.asarray(state["loop_edges"])]
        self._loop_meas = []
        self._loop_stack = (transform(state["loop_rot"], state["loop_trans"])
                            if "loop_rot" in state else None)
        self._kf_cloud_stack = None
        self._kf_cloud_folded = 0
        self._tried_pairs = {(int(i), int(j)) for i, j in np.asarray(state["tried_pairs"])}
        self._kf_since_refine = int(state["kf_since_refine"])
        self._desc_queried = int(state.get("desc_queried", 0))
        self._cost_hist = [float(c) for c in np.asarray(state["cost_hist"])]
        self._closure_weights_dev = None
        self._robust_scale_used = None
        self._solve_events = []
        if self._pipelined:
            dtype = state["kf_points"].dtype
            hist = np.zeros((HIST,), dtype=dtype)
            tail = np.asarray(state["cost_hist"], dtype=dtype)[-HIST:]
            if tail.size:
                hist[HIST - tail.size:] = tail
            self._hist = tensor(hist)
            self._hist_count = torch.tensor(min(tail.size, HIST), dtype=torch.int32, device=dev)
            self._pending = None
            self._correction = None
        self._cur_kf_pose = RigidTransform(self._kf_poses.rotation[-1],
                                           self._kf_poses.translation[-1])
        self._pose = transform(state["pose_rot"], state["pose_trans"])
        if self._pipelined:
            if "prev_points" in state:
                self._prev_scan = PointCloud(tensor(state["prev_points"]),
                                             tensor(state["prev_count"]).to(torch.int32))
            else:
                # A serial checkpoint: the next scan registers against the
                # last keyframe, so the chain goes on from that keyframe's
                # pose, not from the live scan's.
                self._prev_scan = self._kf_clouds[-1]
                self._pose = self._cur_kf_pose
        if self._loop_detector == "descriptor":
            # A pure function of the restored clouds: recomputed.
            self._kf_descs = [scan_context(c.points, c.mask, max_radius=self._desc_range)
                              for c in self._kf_clouds]

    def relocalize(self, scan: PointCloud, **kwargs) -> "RelocResult | None":
        """Relocalize ``scan`` against this session's keyframe map (needs
        ``loop_detector='descriptor'``: its descriptor database is the index).
        ``kwargs`` override :func:`relocalize`'s gates.  The session state is
        not modified."""
        if self._loop_detector != "descriptor":
            raise ValueError(
                "relocalize needs loop_detector='descriptor' (the keyframe "
                "descriptor database is only maintained in that mode)")
        if not self._kf_clouds:
            return None
        stack = PointCloud(torch.stack([c.points for c in self._kf_clouds]),
                           torch.stack([c.count for c in self._kf_clouds]))
        return relocalize(scan, stack, self.keyframe_poses, self._method, self._config,
                          descriptor_range=self._desc_range,
                          keyframe_descriptors=torch.stack(self._kf_descs), **kwargs)

    def _cost_hist_np(self) -> np.ndarray:
        """The accepted-cost history as float64, newest last."""
        if self._pipelined and self._hist is not None:
            count = int(self._hist_count)
            hist = _np(self._hist).astype(np.float64)
            return hist[HIST - count:] if count else np.zeros((0,), np.float64)
        return np.asarray(self._cost_hist, dtype=np.float64)

    def finalize(self) -> bool:
        """One last closure search and robust solve over what arrived since
        the last periodic refinement (revisits often land in the final
        keyframes); True if a solve ran or was applied.  Pipelined mode
        flushes first; asynchronous solves are applied before returning."""
        if self._pipelined:
            self.flush()
        if len(self._kf_clouds) < 2:
            return False
        applied = self._maybe_apply_async(force=True)
        refined = self._refine()
        refined = self._maybe_apply_async(force=True) or refined
        self._kf_since_refine = 0
        return refined or applied

    # -- internals ----------------------------------------------------------

    def _dispatch_solve(self, solve, k: int, n_loop: int, inputs: tuple) -> None:
        """Hand ``solve`` to the worker thread.  On the card its stream first
        waits for the session's stream, where the graph was built."""
        if self._executor is None:
            self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="slam-solve")
            if self._device.type == "cuda":
                self._solve_stream = torch.cuda.Stream(device=self._device)
        events = None
        if self._solve_stream is not None:
            self._solve_stream.wait_stream(torch.cuda.current_stream(self._device))
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        future = self._executor.submit(_solve_job, solve, k, n_loop, self._solve_stream, events)
        self._async_solve = _AsyncSolve(future, inputs, events)

    def _wait_solve(self, pend: _AsyncSolve) -> None:
        """Wait for ``pend``'s worker; on the card the session's stream then
        waits for the solve's end event."""
        wait([pend.future])
        if pend.events is not None and pend.future.exception() is None:
            torch.cuda.current_stream(self._device).wait_event(pend.events[1])

    def _drop_async(self) -> None:
        """Wait out an outstanding solve and drop it unapplied: its result
        belongs to the state being replaced."""
        pend, self._async_solve = self._async_solve, None
        if pend is not None:
            self._wait_solve(pend)

    def _maybe_apply_async(self, force: bool = False) -> bool:
        """Apply a finished asynchronous refinement (unless ``force``, only
        when :meth:`_AsyncSolve.ready`); False when none is outstanding.  The
        correction ``C = new_anchor ∘ old_anchor⁻¹`` moves every pose
        chained from the snapshot's anchor since: the keyframes promoted
        meanwhile, the live pose, and in pipelined mode the scans in flight
        (recorded in ``_correction``)."""
        pend = self._async_solve
        if pend is None or not (force or pend.ready()):
            return False
        self._async_solve = None
        with nvtx_range("slam.refine.apply", self._device):
            self._wait_solve(pend)
            new_poses, w_slice, scale, k_snap = pend.future.result()  # a worker's failure raises
            if pend.events is not None:
                self._solve_events.append(pend.events)
            if self._solve_stream is not None:
                # Made on the worker's stream, now used on the session's.
                stream = torch.cuda.current_stream(self._device)
                for t in (new_poses.rotation, new_poses.translation, w_slice, scale):
                    t.record_stream(stream)
            poses_now = self.keyframe_poses
            old_anchor = RigidTransform(poses_now.rotation[k_snap - 1],
                                        poses_now.translation[k_snap - 1])
            new_anchor = RigidTransform(new_poses.rotation[k_snap - 1],
                                        new_poses.translation[k_snap - 1])
            corr = geometry.compose(new_anchor, geometry.inverse(old_anchor))
            if poses_now.translation.shape[0] > k_snap:
                tail = geometry.compose(corr, RigidTransform(poses_now.rotation[k_snap:],
                                                             poses_now.translation[k_snap:]))
                new_poses = RigidTransform(torch.cat([new_poses.rotation, tail.rotation]),
                                           torch.cat([new_poses.translation, tail.translation]))
            self._kf_poses = new_poses
            self._cur_kf_pose = RigidTransform(new_poses.rotation[-1], new_poses.translation[-1])
            self._pose = geometry.compose(corr, self._pose)
            if self._pipelined and (self._pending is not None or self._in_flight):
                self._correction = (corr if self._correction is None
                                    else geometry.compose(corr, self._correction))
            self._closure_weights_dev = w_slice
            self._robust_scale_used = scale
        return True

    def _promote(self, scan: PointCloud, pose: RigidTransform) -> None:
        if self._kf_clouds:
            # The keyframe-to-keyframe odometry measurement, fixed at
            # promotion: re-deriving it from refined poses would absorb a
            # wrong closure's bend into the measurements.
            self._odo_meas.append(geometry.compose(geometry.inverse(self._cur_kf_pose), pose))
            self._odo_weight_scale.append(1.0)
        self._kf_pending.append(pose)
        self._kf_clouds.append(scan)
        if self._loop_detector == "descriptor":
            self._kf_descs.append(scan_context(scan.points, scan.mask,
                                               max_radius=self._desc_range))
        self._cur_kf_pose = pose

    def _candidates(self, poses: RigidTransform, k: int):
        """Loop candidates ``(K, 2)`` on the host and, in descriptor mode, each
        pair's yaw; already-tried pairs are excluded before the
        ``loop_max_candidates`` truncation."""
        exclude = None
        if self._tried_pairs:
            ex = np.zeros((k, k), dtype=bool)
            tried = np.asarray(sorted(self._tried_pairs), dtype=np.int64)
            ex[tried[:, 0], tried[:, 1]] = True
            exclude = torch.as_tensor(ex, device=self._device)
        if self._loop_detector == "descriptor":
            # Descriptors are immutable: only pairs whose newer member
            # arrived since the last refinement are scored.
            cands, yaws = find_loop_candidates_descriptor_incremental(
                torch.stack(self._kf_descs), self._desc_queried, self._desc_max_dist,
                min_separation=self._loop_min_sep, max_candidates=self._loop_max_cands,
                exclude=exclude)
            self._desc_queried = k
            cands = _np(cands).reshape(-1, 2)
            return cands, {(int(i), int(j)): float(y)
                           for (i, j), y in zip(cands, _np(yaws))}
        cands = pose_graph.find_loop_candidates(
            poses, radius=self._loop_radius, min_separation=self._loop_min_sep,
            max_candidates=self._loop_max_cands, exclude=exclude)
        return _np(cands).reshape(-1, 2), {}

    def _refine(self) -> bool:
        """Detect and register new closures, robust-solve, re-anchor (with
        ``async_refine``: hand the solve to the worker and return False).
        While an asynchronous solve is outstanding, a refinement applies it
        if it has finished and is deferred otherwise."""
        if self._async_solve is not None and not self._maybe_apply_async():
            return False
        with nvtx_range("slam.refine", self._device):
            return self._refine_now()

    def _refine_now(self) -> bool:
        poses = self.keyframe_poses
        k = len(self._kf_clouds)
        cands, yaw_by_pair = self._candidates(poses, k)
        fresh = [(int(i), int(j)) for i, j in cands
                 if (int(i), int(j)) not in self._tried_pairs and int(j) < k]
        if fresh:
            self._tried_pairs.update(fresh)
            stack = self._folded_clouds()
            pairs = torch.as_tensor(fresh, dtype=torch.int32, device=self._device)
            guesses = None
            if self._loop_detector == "descriptor":
                guesses = yaw_seeds(stack, pairs, torch.as_tensor(
                    [yaw_by_pair[p] for p in fresh], dtype=stack.dtype, device=self._device))
            edges, meas, _ = pose_graph.register_loop_closures(
                stack, poses, pairs, self._method, self._config, max_cost=self._loop_max_cost,
                coarse=self._loop_coarse and guesses is None, guesses=guesses,
                converge_fn=self._fn)
            seen = set(self._loop_edges)
            accepted_rows = []
            for idx, (i, j) in enumerate(_np(edges).reshape(-1, 2)):
                pair = (int(i), int(j))
                if pair in seen:
                    continue  # already accepted
                seen.add(pair)
                self._loop_edges.append(pair)
                accepted_rows.append(idx)
            if accepted_rows:
                rows = torch.as_tensor(accepted_rows, dtype=torch.long, device=self._device)
                self._loop_meas.append(RigidTransform(meas.rotation[rows],
                                                      meas.translation[rows]))
        if not self._loop_edges:
            return False

        n_loop = len(self._loop_edges)
        dtype, dev = poses.dtype, self._device
        odo = self._folded_odo()
        odo_w = torch.as_tensor(self._odometry_weight * np.asarray(self._odo_weight_scale),
                                dtype=dtype, device=dev)
        loop_ij = torch.as_tensor(self._loop_edges, dtype=torch.int32, device=dev)
        loop_w = torch.full((n_loop,), self._loop_weight, dtype=dtype, device=dev)
        loop_info = None
        if self._closure_information:
            from .ops.covariance import cloud_information

            # Information from each closure's target keyframe geometry.
            clouds = self._folded_clouds()
            tgt = torch.as_tensor([a for a, _ in self._loop_edges], dtype=torch.long, device=dev)
            loop_info = cloud_information(PointCloud(clouds.points[tgt], clouds.count[tgt]),
                                          k=self._information_neighbors)
        graph, mask = _assemble_graph(poses, odo, odo_w, loop_ij, self._folded_loop(), loop_w,
                                      loop_info)
        # Regime selection: the two-pass solve at mapping scale, single-pass
        # below.
        if self._robust != "none" and self._scale_passes != 1 and (
                self._scale_passes != "auto" or n_loop >= self._mapping_threshold):
            passes = 2 if self._scale_passes == "auto" else int(self._scale_passes)
            solve = functools.partial(
                _solve_two_pass, graph, mask, odo, self._mapping_kernel, self._robust_scale,
                passes, self._gn_iterations, self._gn_solver)
        else:
            solve = functools.partial(_solve_single, graph, mask, self._robust,
                                      self._robust_scale, self._gn_iterations, self._gn_solver)
        if self._async_refine:
            with nvtx_range("slam.refine.dispatch", dev):
                self._dispatch_solve(solve, k, n_loop, (graph, mask, odo))
            return False
        new_poses, w, scale = solve()
        self._closure_weights_dev = w[k - 1:k - 1 + n_loop]  # after the odometry block
        self._robust_scale_used = scale
        # Re-anchor: new keyframe poses; the live pose keeps its offset from
        # the current keyframe.
        old_kf = self._cur_kf_pose
        self._kf_poses = new_poses
        self._cur_kf_pose = RigidTransform(new_poses.rotation[k - 1],
                                           new_poses.translation[k - 1])
        rel_live = geometry.compose(geometry.inverse(old_kf), self._pose)
        self._pose = geometry.compose(self._cur_kf_pose, rel_live)
        return True


@dataclasses.dataclass(frozen=True)
class MergeReport:
    """Evidence behind a :func:`merge_sessions` call."""

    anchor: RigidTransform  # world_a-from-world_b
    keyframes: tuple  # (k_a, k_b)
    new_closures: int  # closures the merge refinement added (mostly cross-session)
    refined: bool  # the joint robust solve ran


def merge_sessions(
    a: OnlineSlam,
    b: OnlineSlam,
    *,
    anchor: RigidTransform | None = None,
    refine: bool = True,
    relocalize_kwargs: dict | None = None,
) -> tuple[OnlineSlam, MergeReport]:
    """Merge two sessions of one environment into one continuing
    :class:`OnlineSlam` on ``a``'s device, with ``a``'s method and knobs.

    ``anchor`` is the ``world_a``-from-``world_b`` transform; ``None``
    recovers it by relocalizing ``b``'s first keyframe in ``a``'s descriptor
    database (both sessions in ``loop_detector='descriptor'`` mode; a
    ``ValueError`` when no keyframe passes the appearance gate).

    The merge is a state union through :meth:`OnlineSlam.state_dict` /
    :meth:`~OnlineSlam.load_state`: keyframes concatenate (``b``'s poses
    mapped through the anchor), relative measurements carry over, one
    bridge odometry edge (weight x1e-3: its measurement comes from ``a``'s
    drifted estimate) keeps the graph one chain, and an anchor loop edge
    ties ``b``'s first keyframe to the anchoring keyframe.  ``refine=True``
    then refines to saturation (at most 16 rounds, each must add a
    closure): the candidate search finds the cross-session revisits.
    ``a`` and ``b`` stay usable (flushed).
    """
    if not a._kf_clouds or not b._kf_clouds:
        raise ValueError("both sessions need at least one keyframe")
    sa = a.state_dict()
    sb = b.state_dict()
    if sa["kf_points"].shape[1:] != sb["kf_points"].shape[1:]:
        raise ValueError(
            f"cloud capacities differ: {sa['kf_points'].shape[1:]} vs "
            f"{sb['kf_points'].shape[1:]} — pad both sessions alike")
    k_a = int(sa["num_keyframes"])
    k_b = int(sb["num_keyframes"])

    anchor_kf = 0  # the session-a keyframe the anchor edge ties to
    if anchor is None:
        if a._loop_detector != "descriptor" or b._loop_detector != "descriptor":
            raise ValueError(
                "anchor=None recovers the inter-session transform by "
                "relocalization, which needs both sessions in "
                "loop_detector='descriptor' mode; pass an explicit anchor otherwise")
        first_b = PointCloud(torch.as_tensor(sb["kf_points"][0], device=a._device),
                             torch.as_tensor(sb["kf_counts"][0], device=a._device))
        reloc = a.relocalize(first_b, **(relocalize_kwargs or {}))
        if reloc is None:
            raise ValueError(
                "relocalization found no appearance match for b's first "
                "keyframe in a's map — pass an explicit anchor")
        # reloc.pose is b_kf0's pose in world_a: anchor = pose_a ∘ pose_b^-1.
        b0 = RigidTransform(torch.as_tensor(sb["kf_rot"][0], device=a._device),
                            torch.as_tensor(sb["kf_trans"][0], device=a._device))
        anchor = geometry.compose(reloc.pose, geometry.inverse(b0))
        anchor_kf = int(reloc.keyframe)

    ar = _np(anchor.rotation).astype(sa["kf_rot"].dtype)
    at = _np(anchor.translation).astype(sa["kf_trans"].dtype)
    rot_b = np.einsum("ij,kjl->kil", ar, sb["kf_rot"])
    trans_b = np.einsum("ij,kj->ki", ar, sb["kf_trans"]) + at

    # Bridge odometry measurement a_last^-1 ∘ (anchor ∘ b_0), and the anchor
    # loop edge X_anchor_kf^-1 ∘ (anchor ∘ b_0), both in world_a.
    a_last_r, a_last_t = sa["kf_rot"][-1], sa["kf_trans"][-1]
    br = a_last_r.T @ rot_b[0]
    bt = a_last_r.T @ (trans_b[0] - a_last_t)
    ak_r, ak_t = sa["kf_rot"][anchor_kf], sa["kf_trans"][anchor_kf]
    anchor_edge_r = ak_r.T @ rot_b[0]
    anchor_edge_t = ak_r.T @ (trans_b[0] - ak_t)

    def cat(*parts):
        return np.concatenate([x for x in parts if x is not None], axis=0)

    state = {
        "num_keyframes": np.asarray(k_a + k_b),
        "kf_points": cat(sa["kf_points"], sb["kf_points"]),
        "kf_counts": cat(sa["kf_counts"], sb["kf_counts"]),
        "kf_rot": cat(sa["kf_rot"], rot_b),
        "kf_trans": cat(sa["kf_trans"], trans_b),
        "pose_rot": ar @ sb["pose_rot"],  # b's live pose, in world_a
        "pose_trans": ar @ sb["pose_trans"] + at,
        "kf_since_refine": np.asarray(0),
        # The anomaly retry's baseline: the tail of both histories.
        "cost_hist": cat(sa["cost_hist"], sb["cost_hist"])[-HIST:],
        "tried_pairs": cat(sa["tried_pairs"].reshape(-1, 2), sb["tried_pairs"].reshape(-1, 2) + k_a,
                           np.asarray([[anchor_kf, k_a]], dtype=np.int64)),
        # Every b keyframe is new to the merged descriptor database.
        "desc_queried": np.asarray(min(int(sa.get("desc_queried", 0)), k_a)),
        "loop_edges": cat(sa["loop_edges"].reshape(-1, 2), sb["loop_edges"].reshape(-1, 2) + k_a,
                          np.asarray([[anchor_kf, k_a]], dtype=np.int64)),
        "odo_rot": cat(sa.get("odo_rot"), br[None], sb.get("odo_rot")),
        "odo_trans": cat(sa.get("odo_trans"), bt[None], sb.get("odo_trans")),
        "odo_weight_scale": cat(
            np.asarray(sa.get("odo_weight_scale", np.ones(max(k_a - 1, 0)))),
            np.asarray([1e-3]),
            np.asarray(sb.get("odo_weight_scale", np.ones(max(k_b - 1, 0))))),
        "loop_rot": cat(sa.get("loop_rot"), sb.get("loop_rot"), anchor_edge_r[None]),
        "loop_trans": cat(sa.get("loop_trans"), sb.get("loop_trans"), anchor_edge_t[None]),
    }
    if "prev_points" in sb:
        state["prev_points"] = sb["prev_points"]
        state["prev_count"] = sb["prev_count"]

    merged = OnlineSlam(
        a._method, a._config,
        translation_threshold=a._tt, angle_threshold=a._ta,
        loop_every=a._loop_every, loop_radius=a._loop_radius,
        loop_detector=a._loop_detector, descriptor_range=a._desc_range,
        descriptor_max_distance=a._desc_max_dist, loop_min_separation=a._loop_min_sep,
        loop_max_candidates=a._loop_max_cands, loop_max_cost=a._loop_max_cost,
        loop_coarse=a._loop_coarse, loop_weight=a._loop_weight,
        odometry_weight=a._odometry_weight, robust=a._robust, robust_scale=a._robust_scale,
        scale_passes=a._scale_passes, mapping_kernel=a._mapping_kernel,
        mapping_threshold=a._mapping_threshold, gn_iterations=a._gn_iterations,
        gn_solver=a._gn_solver, closure_information=a._closure_information,
        information_neighbors=a._information_neighbors, pipelined=a._pipelined,
        async_refine=a._async_refine, device=a._device,
    )
    merged.load_state(state)
    before = len(merged._loop_edges)
    refined = False
    if refine:
        # Refine to saturation: each solve brings more cross-session pairs
        # inside the radius; the tried-pair exclusion keeps the budget on
        # fresh pairs, so a round that accepts nothing ends it.
        for _ in range(16):
            seen = len(merged._loop_edges)
            if merged._loop_detector == "descriptor":
                # Re-score everything each round (the incremental cursor
                # would stop after one).
                merged._desc_queried = 0
            refined = merged._refine() or refined
            # Saturation is a batch loop: land an asynchronous solve before
            # deciding whether the round added closures.
            merged._maybe_apply_async(force=True)
            if len(merged._loop_edges) == seen:
                break
    return merged, MergeReport(anchor=anchor, keyframes=(k_a, k_b),
                               new_closures=len(merged._loop_edges) - before, refined=refined)


@dataclasses.dataclass(frozen=True)
class SlamResult:
    poses: RigidTransform  # optimized world-from-scan poses (T, ...)
    trajectory: odometry.Trajectory  # raw odometry (pre-optimization)
    loop_edges: torch.Tensor  # (K, 2) accepted closures
    graph_costs: torch.Tensor  # per-GN-iteration costs (+ final)
    edge_weights: torch.Tensor | None = None  # (E,) final IRLS weights (robust only)


def run_slam(
    scans: PointCloud,
    method: Method,
    config: DriverConfig,
    *,
    coarse: bool = False,
    multiscale: bool = False,
    loop_radius: float | None = None,
    loop_detector: str = "radius",
    descriptor_range: float | None = None,
    descriptor_max_distance: float = 0.2,
    descriptor_seed: bool = True,
    loop_min_separation: int = 10,
    loop_max_candidates: int | None = 64,
    loop_max_cost: float | None = None,
    loop_coarse: bool = False,
    loop_weight: float = 10.0,
    gn_iterations: int | None = None,
    gn_solver: str = "dense",
    robust: str = "none",
    robust_scale: float | str = "auto",
    scale_passes: int | str = "auto",
    mapping_kernel: str = "welsch",
    mapping_threshold: int = 12,
    closure_information: bool = False,
    information_neighbors: int = 10,
) -> SlamResult:
    """Odometry + (optional) loop closure + pose-graph refinement over the
    batched ``(T, N, D)`` scan stack, on the scans' device.

    ``loop_radius=None`` runs the odometry chain only.
    ``loop_detector='descriptor'`` retrieves candidates by Scan Context
    appearance (``descriptor_range`` = sensor range), each registration
    seeded by the descriptor's yaw (``descriptor_seed``).  ``robust`` picks
    a kernel for the closure edges (``gn_iterations`` defaults to 10, 30
    with a kernel); ``scale_passes='auto'`` switches to the two-pass
    ``mapping_kernel`` solve (:func:`icp_tpu_torch.pose_graph.robust_solve`)
    from ``mapping_threshold`` closures.  ``closure_information`` attaches
    each closure's information from its target scan's geometry.
    """
    if gn_iterations is None:
        gn_iterations = 10 if robust == "none" else 30
    traj = odometry.chain_scans(scans, method, config, coarse=coarse, multiscale=multiscale)
    if loop_detector not in ("radius", "descriptor"):
        raise ValueError(f"loop_detector must be 'radius' or 'descriptor', got {loop_detector!r}")
    device = scans.points.device
    loop_edges = torch.zeros((0, 2), dtype=torch.int32, device=device)
    loop_meas = None
    if loop_detector == "descriptor":
        if descriptor_range is None:
            raise ValueError(
                "loop_detector='descriptor' needs descriptor_range "
                "(the sensor range; a common constant across scans)")
        descs = scan_context(scans.points, scans.mask, max_radius=descriptor_range)
        cands, yaw = find_loop_candidates_descriptor(
            descs, descriptor_max_distance, min_separation=loop_min_separation,
            max_candidates=loop_max_candidates)
        guesses = yaw_seeds(scans, cands, yaw) if descriptor_seed else None
        loop_edges, loop_meas, _ = pose_graph.register_loop_closures(
            scans, traj.poses, cands, method, config, max_cost=loop_max_cost,
            coarse=loop_coarse, guesses=guesses)
    elif loop_radius is not None:
        cands = pose_graph.find_loop_candidates(
            traj.poses, radius=loop_radius, min_separation=loop_min_separation,
            max_candidates=loop_max_candidates)
        loop_edges, loop_meas, _ = pose_graph.register_loop_closures(
            scans, traj.poses, cands, method, config, max_cost=loop_max_cost,
            coarse=loop_coarse)

    if loop_edges.shape[0] == 0:
        # An odometry-only graph is exactly satisfied: nothing to solve.
        return SlamResult(poses=traj.poses, trajectory=traj, loop_edges=loop_edges,
                          graph_costs=torch.zeros((0,), dtype=scans.dtype, device=device))

    loop_info = None
    if closure_information:
        from .ops.covariance import cloud_information

        tgt = loop_edges[:, 0].long()
        loop_info = cloud_information(PointCloud(scans.points[tgt], scans.count[tgt]),
                                      k=information_neighbors)
    graph = pose_graph.graph_from_trajectory(
        traj.poses, geometry.inverse(traj.relative), loop_edges=loop_edges,
        loop_measurements=loop_meas, loop_weight=loop_weight, loop_information=loop_info)
    # The kernel acts on the closures only: a redescending kernel on the
    # odometry edges can disconnect the chain.
    robust_mask = None
    if robust != "none":
        n_odo = graph.num_edges - loop_edges.shape[0]
        robust_mask = torch.arange(graph.num_edges, device=device) >= n_odo
    if isinstance(scale_passes, str) and scale_passes != "auto":
        raise ValueError(f"scale_passes must be an int or 'auto', got {scale_passes!r}")
    two_pass = robust != "none" and scale_passes != 1 and (
        scale_passes != "auto" or int(loop_edges.shape[0]) >= mapping_threshold)
    weights = None
    if two_pass:
        graph, costs, robust_scale, weights = pose_graph.robust_solve(
            graph, kernel=mapping_kernel, robust_edges=robust_mask, iterations=gn_iterations,
            solver=gn_solver, robust_scale=robust_scale,
            scale_passes=2 if scale_passes == "auto" else int(scale_passes))
    else:
        if robust != "none" and isinstance(robust_scale, str):
            # 'auto': resolved once, reused by the weights diagnostic.
            robust_scale = pose_graph.auto_robust_scale(
                graph, iterations=gn_iterations, solver=gn_solver, robust_edges=robust_mask)
        graph, costs = pose_graph.optimize(
            graph, iterations=gn_iterations, solver=gn_solver, robust=robust,
            robust_scale=robust_scale, robust_edges=robust_mask)
        if robust != "none":
            weights, _ = pose_graph.robust_edge_weights(graph, robust, robust_scale,
                                                        robust_edges=robust_mask)
    return SlamResult(poses=graph.poses, trajectory=traj, loop_edges=loop_edges,
                      graph_costs=costs, edge_weights=weights)


@dataclasses.dataclass(frozen=True)
class RelocResult:
    """Outcome of :func:`relocalize`: the query scan's world pose, the
    matched keyframe, and the evidence behind the match."""

    pose: RigidTransform
    keyframe: int
    cost: float
    descriptor_distance: float


def relocalize(
    scan: PointCloud,
    keyframes: PointCloud,
    keyframe_poses: RigidTransform,
    method: Method,
    config: DriverConfig,
    *,
    descriptor_range: float,
    max_distance: float = 0.3,
    top_k: int = 3,
    max_cost: float | None = None,
    keyframe_descriptors=None,
) -> RelocResult | None:
    """Global relocalization with no pose prior, on the tensors' device:
    Scan Context retrieval proposes the ``top_k`` most similar keyframes
    under ``max_distance``, each registration is seeded with the
    descriptor's yaw, and the lowest cost wins (``max_cost`` gates it).  The
    pose is ``keyframe_pose ∘ T``, T registering the scan onto the matched
    keyframe.  ``keyframe_descriptors`` (``(K, R, S)`` at the same
    ``descriptor_range``) skips rebuilding the database.  None when nothing
    passes the gates.
    """
    if keyframe_descriptors is None:
        keyframe_descriptors = scan_context(keyframes.points, keyframes.mask,
                                            max_radius=descriptor_range)
    q_desc = scan_context(scan.points, scan.mask, max_radius=descriptor_range)
    # Keyframes on the query axis, the scan on the database axis: shift[k]
    # aligns the scan to keyframe k, yaw_seeds' "j relative to i".
    dist, shift = descriptor_query(keyframe_descriptors, q_desc[None])
    dist, shift = _np(dist[:, 0]), _np(shift[:, 0])
    order = np.argsort(dist)[:min(top_k, dist.shape[0])]
    order = order[dist[order] < max_distance]
    if order.size == 0:
        return None
    sectors = keyframe_descriptors.shape[-1]
    yaw = shift[order].astype(np.float64) * (2 * np.pi / sectors)
    yaw = np.where(yaw > np.pi, yaw - 2 * np.pi, yaw)
    device = keyframes.points.device
    # Pairs (i = target keyframe, j = the scan stacked behind them).
    kf_idx = torch.as_tensor(order, dtype=torch.long, device=device)
    nkf = keyframes.points.shape[0]
    stack = PointCloud(
        torch.cat([keyframes.points, scan.points[None]]),
        torch.cat([keyframes.count, scan.count.reshape(1).to(keyframes.count.dtype)]))
    pairs = torch.stack([kf_idx, torch.full_like(kf_idx, nkf)], dim=-1)
    seeds = yaw_seeds(stack, pairs, torch.as_tensor(yaw, dtype=scan.dtype, device=device))
    src = PointCloud(scan.points.expand(order.size, *scan.points.shape).contiguous(),
                     scan.count.expand(order.size).contiguous())
    tgt = PointCloud(keyframes.points[kf_idx], keyframes.count[kf_idx])
    result, _ = converge(method, src, tgt, seeds, config)
    costs = _np(result.cost)
    best = int(np.argmin(costs))
    if max_cost is not None and costs[best] > max_cost:
        return None
    kf = int(order[best])
    t_rel = RigidTransform(result.transform.rotation[best], result.transform.translation[best])
    kf_pose = RigidTransform(keyframe_poses.rotation[kf], keyframe_poses.translation[kf])
    return RelocResult(pose=geometry.compose(kf_pose, t_rel), keyframe=kf,
                       cost=float(costs[best]), descriptor_distance=float(dist[kf]))
