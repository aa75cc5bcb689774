"""Command-line interface: ``python -m icp_tpu_torch.cli``.

Port of :mod:`icp_tpu.cli`:

* ``view`` — the SDL GUI driver (``vis/main.cpp:75-153``) as an offline frame
  renderer: one PNG per iteration (``--every``), ``-l`` dumps each frame's
  iteration, cost and translation, ``--view-conf`` reads the reference's
  display conf, ``--animate`` assembles a GIF or an HTML player.
* ``bench`` — the reference's benchmark report (``bench/bench.cpp:108-142``):
  every registered 2D method (or ``--methods``) on scans 1-3, ``--invocations``
  calls each, the cost and iteration statistics and the time per invocation
  and per iteration; ``--batch N`` adds the batched throughput.  The clock is
  read after the card's queued work has finished.
* ``register`` — one-shot registration of a 2D scan pair (CSV, or a ``.conf``
  polar sweep) or, with ``--ply``, a 3D PLY pair, under the driver flags;
  ``--sor`` filters outliers from both clouds first, ``--coarse`` seeds the
  registration with the global initializer.  Prints the pose (``--json``:
  one JSON object) and can write the moved source (``--out-ply``).
* ``odometry`` — a scan sequence into a trajectory: every consecutive pair
  in one batch (``--coarse``, ``--multiscale``), or ``--scan-to-map``
  against an aggregated voxel map (``--device-map`` keeps it on the card);
  with ``--optimize`` / ``--loop-radius`` / ``--loop-descriptor RANGE`` the
  offline back end: loop candidates within the radius or by Scan Context
  appearance, registered in one batch, then a pose-graph solve
  (``--robust-kernel``, ``--scale-passes``, ``--closure-information``);
  ``--online`` streams the scans through ``slam.OnlineSlam`` instead
  (``--pipelined``, ``--async-refine``, ``--loop-every``,
  ``--keyframe-translation`` / ``--keyframe-angle``, ``--odometry-weight``);
  one JSON record per scan, with ``--eval GT_TUM`` one more with the ATE and
  RPE against a TUM ground truth; ``--save`` writes the poses to an ``.npz``
  checkpoint and ``--render`` the trajectory and map to a PNG (batch and
  scan-to-map runs).
* ``graph`` — optimize a g2o pose graph (robust kernels, dense / CG / PCG),
  or run the outlier-injection protocol on it (``--outlier-protocol``).
* ``methods`` — list the registry (the reference prints it on an unknown
  method, ``vis/main.cpp:133-139``).

Inputs load in float32 with power-of-two bucket capacity
(``--exact-capacity``: a multiple of 8), as in the JAX CLI; g2o graphs in
float32 on the card, float64 with ``--platform cpu``.  ``--platform gpu``
(the default) runs on the CUDA card and fails without one; ``--platform
cpu`` runs on the CPU.  Not ported, so refused: the JAX CLI's
``--aot-cache``.  ``bench --data-dir`` defaults to the repository's
``ex_data``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ex_data")


def _parse_config(pairs):
    from .config import Config

    params = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise SystemExit(f"error: config entry {pair!r} is not key=value")
        key, value = pair.split("=", 1)
        try:
            params[key] = int(value)
        except ValueError:
            try:
                params[key] = float(value)
            except ValueError:
                params[key] = value  # string parameters, e.g. solver=quat
    return Config(params)


def _make_method(name: str, dim: int, config):
    from .methods import from_method, registered_methods

    try:
        return from_method(name, dim, config)
    except KeyError:
        print(f"error: unknown ICP method '{name}'. expected one of:", file=sys.stderr)
        for m in registered_methods(dim):
            print(f"* {m}", file=sys.stderr)
        raise SystemExit(1)


def _driver_config(args):
    from .driver import DriverConfig

    return DriverConfig(
        max_iterations=args.max_iterations,
        angle_tolerance=float(np.deg2rad(args.angle_tolerance_deg))
        if args.angle_tolerance_deg is not None
        else None,
        translation_tolerance=args.translation_tolerance,
        stop_cost=args.stop_cost,
        absolute_cost_tolerance=args.absolute_cost_tolerance,
        relative_cost_tolerance=args.relative_cost_tolerance,
    )


def _add_driver_flags(p):
    p.add_argument("--max-iterations", type=int, default=100)
    p.add_argument(
        "--angle-tolerance-deg", type=float, default=0.1,
        help="angle tolerance in degrees (with --translation-tolerance)",
    )
    p.add_argument("--translation-tolerance", type=float, default=0.1)
    p.add_argument("--stop-cost", type=float, default=None)
    p.add_argument("--absolute-cost-tolerance", type=float, default=None)
    p.add_argument("--relative-cost-tolerance", type=float, default=None)


def _device(platform: str) -> torch.device:
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("error: --platform gpu needs a CUDA card (use --platform cpu)")
    return torch.device("cuda", 0)


def _parse_view_conf(path: str) -> dict:
    """Parse the reference's display conf (``view.conf:1-7``: window_width/
    height, x/y_displace, view_scale as ``key = value`` lines)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            try:
                out[key.strip()] = float(value.strip())
            except ValueError:
                pass
    return out


def _load_scan(path: str, capacity, device):
    """A 2D scan by extension: ``.conf`` polar sweep, else CSV."""
    from .io import parse_lidar_scan, parse_sweep

    load = parse_sweep if path.endswith(".conf") else parse_lidar_scan
    return load(path, capacity=capacity, dtype=torch.float32, device=device)


def cmd_register(args):
    from . import geometry
    from .cloud import from_points
    from .driver import converge
    from .io import read_ply, write_ply
    from .multiscale import converge_multiscale

    device = _device(args.platform)
    config = _parse_config(args.config)
    cap = None if args.exact_capacity else "bucket"
    if args.ply:
        source, target = (
            from_points(read_ply(p), capacity=cap, dtype=torch.float32, device=device)
            for p in (args.src, args.dst)
        )
        dim = 3
    else:
        source = _load_scan(args.src, cap, device)
        target = _load_scan(args.dst, cap, device)
        dim = 2
    if args.sor:
        from .ops.filters import remove_statistical_outliers

        source = remove_statistical_outliers(source)
        target = remove_statistical_outliers(target)
    method = _make_method(args.method, dim, config)
    cfg = _driver_config(args)
    guess = geometry.identity(dim, dtype=torch.float32, device=device)
    if args.coarse:
        from .ops.coarse import coarse_align_2d, coarse_align_3d

        guess = (coarse_align_2d if dim == 2 else coarse_align_3d)(source, target)

    t0 = time.perf_counter()
    if args.multiscale:
        result, _ = converge_multiscale(
            method, source, target, guess, cfg, factors=(4,), coarse_max_iterations=30
        )
    else:
        result, _ = converge(method, source, target, guess, cfg)
    rotation = result.transform.rotation.cpu().numpy()
    dt = time.perf_counter() - t0

    out = {
        "method": args.method,
        "iterations": int(result.iteration_count),
        "cost": float(result.cost),
        "rotation": rotation.tolist(),
        "translation": result.transform.translation.cpu().numpy().tolist(),
        "seconds": round(dt, 4),
    }
    if args.json:
        print(json.dumps(out))
    else:
        print(f"converged in {out['iterations']} iterations, cost {out['cost']:.6f}")
        print("rotation:")
        for row in out["rotation"]:
            print("  " + "  ".join(f"{v: .8f}" for v in row))
        print("translation: " + "  ".join(f"{v: .8f}" for v in out["translation"]))
    if args.out_ply:
        moved = geometry.apply(result.transform, source.points)[: int(source.count)]
        moved = moved.cpu().numpy()
        if moved.shape[1] == 2:  # PLY vertices are xyz; z = 0 for 2D scans
            moved = np.column_stack([moved, np.zeros(len(moved), dtype=moved.dtype)])
        write_ply(args.out_ply, moved)
        print(f"wrote {args.out_ply}")


def cmd_view(args):
    from .geometry import identity
    from .vis import assemble_animation, render_registration

    device = _device(args.platform)
    view_conf = _parse_view_conf(args.view_conf) if args.view_conf else {}
    source = _load_scan(args.src, None, device)
    target = _load_scan(args.dst, None, device)
    method = _make_method(args.method, 2, _parse_config(args.config))

    def log(dump):
        if args.log:
            print(f"iteration={dump.iteration} cost={dump.cost:.6f} "
                  f"t={dump.translation.tolist()}")

    dumps = render_registration(
        method, source, target, identity(2, dtype=torch.float32, device=device),
        out_dir=args.out, iterations=args.iterations, every=args.every,
        light_mode=args.basic_mode, log=log, view_conf=view_conf)
    print(f"wrote {len(range(0, args.iterations + 1, args.every))} frames to {args.out}")
    print(f"final cost {dumps[-1].cost:.6f}")
    if args.animate:
        out = assemble_animation(args.out, args.animate, dumps, fps=args.fps)
        print(f"wrote animation {out}")


def _sync(device) -> None:
    """Wait for the card's queued work before a clock read."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_bench(args):
    from .cloud import PointCloud
    from .driver import DriverConfig, make_converge_fn
    from .geometry import identity
    from .io import parse_lidar_scan
    from .methods import registered_methods

    device = _device(args.platform)
    methods = args.methods or registered_methods(2)
    cfg = DriverConfig(max_iterations=50, angle_tolerance=float(np.deg2rad(0.1)),
                       translation_tolerance=0.01)

    def load(path):
        return parse_lidar_scan(path, dtype=torch.float32, device=device)

    for name in methods:
        for scan_id in args.scans:
            src = load(f"{args.data_dir}/scan{scan_id}/first.csv")
            dst = load(f"{args.data_dir}/scan{scan_id}/second.csv")
            method = _make_method(name, 2, _parse_config(args.config))
            fn = make_converge_fn(method, cfg)
            guess = identity(2, dtype=torch.float32, device=device)
            fn(src, dst, guess)  # warm-up, excluded as the reference excludes process start
            _sync(device)

            costs, iters = [], []
            t0 = time.perf_counter()
            for _ in range(args.invocations):
                result, _ = fn(src, dst, guess)
                costs.append(float(result.cost))
                iters.append(int(result.iteration_count))
            _sync(device)
            dt = time.perf_counter() - t0

            batched_line = ""
            if args.batch:
                bsz = args.batch

                def lanes(c):
                    return PointCloud(c.points.expand(bsz, *c.points.shape).contiguous(),
                                      c.count.expand(bsz).contiguous())

                ab, bb = lanes(src), lanes(dst)
                gb = identity(2, (bsz,), dtype=torch.float32, device=device)
                rb, _ = fn(ab, bb, gb)
                float(rb.cost.sum())
                _sync(device)
                t0b = time.perf_counter()
                for _ in range(3):
                    rb, _ = fn(ab, bb, gb)
                    float(rb.cost.sum())
                _sync(device)
                dtb = time.perf_counter() - t0b
                batched_line = (f"* Batched throughput ({bsz} pairs/invocation): "
                                f"{bsz * 3 / dtb:.1f} pairs/s")

            costs_sorted, iters_sorted = sorted(costs), sorted(iters)
            print(f"ICP method: {name}, scan {scan_id}")
            print(f"* Number of invocations: {args.invocations}")
            print(f"* Min cost: {costs_sorted[0]:.6g}")
            print(f"* Max cost: {costs_sorted[-1]:.6g}")
            print(f"* Median cost: {costs_sorted[len(costs) // 2]:.6g}")
            print(f"* Mean cost: {np.mean(costs):.6g}")
            print(f"* Min iterations: {iters_sorted[0]}")
            print(f"* Max iterations: {iters_sorted[-1]}")
            print(f"* Median iterations: {iters_sorted[len(iters) // 2]}")
            print(f"* Mean iterations: {np.mean(iters):.4g}")
            print(f"* Average time per invocation: {dt / args.invocations:.6g}s")
            print(f"* Average time per iteration: {dt / max(sum(iters), 1):.6g}s")
            if batched_line:
                print(batched_line)


def _cli_capacity(cap: int, args) -> int:
    """The power-of-two bucket of ``cap`` unless ``--exact-capacity``."""
    from .cloud import bucket_capacity

    return cap if args.exact_capacity else bucket_capacity(cap)


def _eval_against_tum(poses, gt_path: str, dim: int) -> None:
    """ATE (Umeyama-aligned) and RPE of ``poses`` against a TUM ground-truth
    file, one JSON line on stdout."""
    from . import eval as ev
    from .io import read_tum

    _, gt = read_tum(gt_path, dim=dim, device="cpu")
    n_gt, n_est = gt.translation.shape[0], poses.translation.shape[0]
    if n_gt != n_est:
        raise SystemExit(
            f"--eval: ground truth has {n_gt} poses but the trajectory has "
            f"{n_est} (one TUM line per scan required)")
    record = {"eval_against": gt_path}
    record.update(ev.ate(poses, gt).as_dict())
    record.update(ev.rpe(poses, gt).as_dict())
    print(json.dumps(record))


def _pose_record(path: str, rotation, translation) -> dict:
    return {"scan": path, "rotation": rotation.cpu().numpy().tolist(),
            "translation": translation.cpu().numpy().tolist()}


def _odometry_clouds(args, device):
    """The scans as a list of clouds at one capacity."""
    from .cloud import from_points, pad_to
    from .io import read_ply

    if args.ply:
        clouds = [from_points(read_ply(p), dtype=torch.float32, device=device)
                  for p in args.scans]
    else:
        clouds = [_load_scan(p, None, device) for p in args.scans]
    cap = _cli_capacity(max(c.capacity for c in clouds), args)
    return [pad_to(c, cap) for c in clouds]


def _scan_to_map(args, device, dim) -> None:
    from . import mapping
    from .geometry import RigidTransform

    if args.method in ("trimmed", "vanilla", "feature_aware"):
        print(f"hint: method '{args.method}' is a hard-overlap method; the aggregated map "
              "always contains unobserved regions, which 'robust' down-weights (in long "
              "corridors robust can stall: see icp_tpu_torch.mapping)", file=sys.stderr)
    for flag in ("optimize", "loop_radius", "coarse", "multiscale"):
        if getattr(args, flag):
            print(f"warning: --{flag.replace('_', '-')} is not supported with --scan-to-map "
                  "and is ignored", file=sys.stderr)
    clouds = _odometry_clouds(args, device)
    method = _make_method(args.method, dim, _parse_config(args.config))
    poses = []
    for t, (pose, is_kf, result) in enumerate(mapping.scan_to_map_odometry(
            clouds, method, _driver_config(args), voxel_size=args.voxel_size,
            map_capacity=args.map_capacity, device_map=args.device_map)):
        poses.append(pose)
        rec = _pose_record(args.scans[t], pose.rotation, pose.translation)
        rec["keyframe"] = bool(is_kf)
        if result is not None:
            rec["iterations"] = int(result.iteration_count)
            rec["cost"] = float(result.cost)
        print(json.dumps(rec))
    poses = RigidTransform(torch.stack([p.rotation for p in poses]),
                           torch.stack([p.translation for p in poses]))
    if args.render:
        from .cloud import stack

        _render(args.render, poses, stack(clouds))
    if args.save:
        _save_poses(args.save, poses, "trajectory")
    if args.eval:
        _eval_against_tum(poses, args.eval, dim)


def _render(path: str, poses, scans) -> None:
    from .vis import render_trajectory

    render_trajectory(path, poses, scans=scans)
    print(f"wrote {path}", file=sys.stderr)


def _save_poses(path: str, poses, what: str) -> None:
    from .checkpoint import save_pytree

    save_pytree(path, {"rotation": poses.rotation, "translation": poses.translation})
    print(f"saved {what} to {path}", file=sys.stderr)


def cmd_odometry(args):
    from . import odometry
    from .cloud import pad_to, stack
    from .io import parse_lidar_scan_batch

    device = _device(args.platform)
    dim = 3 if args.ply else 2
    if args.scan_to_map:
        return _scan_to_map(args, device, dim)
    if args.ply or any(p.endswith(".conf") for p in args.scans):
        scans = stack(_odometry_clouds(args, device))
    else:
        scans = parse_lidar_scan_batch(args.scans, dtype=torch.float32, device=device)
        scans = pad_to(scans, _cli_capacity(scans.capacity, args))
    method = _make_method(args.method, dim, _parse_config(args.config))
    cfg = _driver_config(args)
    if args.online:
        return _online(args, scans, method, cfg, device, dim)
    traj = odometry.chain_scans(scans, method, cfg, coarse=args.coarse,
                                multiscale=args.multiscale)
    poses = traj.poses
    if args.optimize or args.loop_radius or args.loop_descriptor:
        poses = _back_end(args, scans, traj, method, cfg)
    for t, path in enumerate(args.scans):
        rec = _pose_record(path, poses.rotation[t], poses.translation[t])
        if t > 0:
            rec["iterations"] = int(traj.registration.iteration_count[t - 1])
            rec["cost"] = float(traj.registration.cost[t - 1])
        print(json.dumps(rec))
    if args.render:
        _render(args.render, poses, scans)
    if args.save:
        _save_poses(args.save, poses, "trajectory")
    if args.eval:
        _eval_against_tum(poses, args.eval, dim)


def _online(args, scans, method, cfg, device, dim) -> None:
    """``odometry --online``: the scans streamed through ``slam.OnlineSlam``
    (periodic robust loop closure, live re-anchoring), one JSON record per
    scan as it materializes; then ``finalize``, its stderr report, and the
    live poses for ``--eval``."""
    from .cloud import PointCloud
    from .geometry import RigidTransform
    from .slam import OnlineSlam

    online = OnlineSlam(
        method, cfg,
        translation_threshold=args.keyframe_translation, angle_threshold=args.keyframe_angle,
        loop_every=args.loop_every, loop_radius=args.loop_radius or 2.0,
        loop_detector="descriptor" if args.loop_descriptor else "radius",
        descriptor_range=args.loop_descriptor,
        descriptor_max_distance=args.descriptor_max_distance,
        loop_min_separation=args.loop_min_separation, loop_max_cost=args.loop_max_cost,
        loop_weight=args.loop_weight, odometry_weight=args.odometry_weight,
        robust=args.robust_kernel, robust_scale=args.robust_scale,
        scale_passes=args.scale_passes, mapping_threshold=args.mapping_threshold,
        closure_information=args.closure_information, pipelined=args.pipelined,
        async_refine=args.async_refine, device=device,
    )
    live = []

    def emit(u):
        path = args.scans[len(live)]
        live.append(u.pose)
        rec = _pose_record(path, u.pose.rotation, u.pose.translation)
        rec.update(keyframe=bool(u.is_keyframe), refined=bool(u.refined),
                   closures=int(u.num_closures))
        print(json.dumps(rec))

    for t in range(scans.points.shape[0]):
        # Pipelined updates arrive one scan late (the first launch returns
        # None).
        u = online.add_scan(PointCloud(scans.points[t], scans.count[t]))
        if u is not None:
            emit(u)
    if args.pipelined:
        u = online.flush()
        if u is not None:
            emit(u)
    flushed = online.finalize()
    kf = online.keyframe_poses
    print(f"online slam: {kf.translation.shape[0]} keyframes, {len(online._loop_edges)} closures"
          + (" (finalize ran a refinement)" if flushed else ""), file=sys.stderr)
    w = online.closure_weights
    if w is not None and len(w):
        # Rejected closures sit near 0, inliers near 1.
        print(f"closure robust weights: min {float(np.min(w)):.4g} "
              f"median {float(np.median(w)):.4g} "
              f"(kept >=0.5: {int((w >= 0.5).sum())}/{len(w)}; "
              f"scale {float(online._robust_scale_used):.4g})", file=sys.stderr)
    if args.save:
        _save_poses(args.save, kf, "keyframe trajectory")
    if args.eval:
        # The live per-scan poses (what the robot acted on), not the
        # keyframe graph.
        _eval_against_tum(RigidTransform(torch.stack([p.rotation for p in live]),
                                         torch.stack([p.translation for p in live])),
                          args.eval, dim)


def _back_end(args, scans, traj, method, cfg):
    """The offline back end of ``odometry``: loop candidates within
    ``--loop-radius`` or by Scan Context appearance (``--loop-descriptor``,
    each seeded by the descriptor's yaw), registered in one batch, then the
    pose-graph solve; returns the optimized poses.  Stderr lines as in the
    JAX CLI."""
    from . import geometry, pose_graph
    from .cloud import PointCloud

    loop_edges = loop_meas = cands = guesses = None
    if args.loop_descriptor:
        from .ops.descriptor import find_loop_candidates_descriptor, scan_context, yaw_seeds

        descs = scan_context(scans.points, scans.mask, max_radius=args.loop_descriptor)
        cands, yaw = find_loop_candidates_descriptor(
            descs, args.descriptor_max_distance, min_separation=args.loop_min_separation)
        guesses = yaw_seeds(scans, cands, yaw)
    elif args.loop_radius:
        cands = pose_graph.find_loop_candidates(traj.poses, radius=args.loop_radius,
                                                min_separation=args.loop_min_separation)
    if cands is not None and len(cands):
        loop_edges, loop_meas, lc_costs = pose_graph.register_loop_closures(
            scans, traj.poses, cands, method, cfg, max_cost=args.loop_max_cost,
            coarse=args.loop_coarse, guesses=guesses)
        print(f"loop closures: {len(loop_edges)} of {len(cands)} candidates accepted "
              f"(costs {np.round(lc_costs.cpu().numpy(), 4).tolist()})", file=sys.stderr)
    loop_info = None
    if args.closure_information and loop_edges is not None:
        from .ops.covariance import cloud_information

        tgt = loop_edges[:, 0].long()
        loop_info = cloud_information(PointCloud(scans.points[tgt], scans.count[tgt]))
    # Edge measurements are frame-t-relative poses of frame t + 1: the
    # inverse of the registration transform (see odometry.compose_chain).
    graph = pose_graph.graph_from_trajectory(
        traj.poses, geometry.inverse(traj.relative), loop_edges=loop_edges,
        loop_measurements=loop_meas, loop_weight=args.loop_weight,
        loop_information=loop_info)
    # Robust kernels act on the loop-closure edges only (a redescending
    # kernel on odometry edges can disconnect the chain).
    robust_mask = None
    robust_scale = args.robust_scale
    gn_iterations = args.gn_iterations
    if gn_iterations is None:
        gn_iterations = 10 if args.robust_kernel == "none" else 30
    n_loop = 0 if loop_edges is None else len(loop_edges)
    two_pass = (args.robust_kernel != "none" and n_loop > 0 and args.scale_passes != 1
                and (args.scale_passes != "auto" or n_loop >= args.mapping_threshold))
    if args.robust_kernel != "none" and loop_edges is not None:
        robust_mask = (torch.arange(graph.num_edges, device=graph.weights.device)
                       >= graph.num_edges - n_loop)
        if not two_pass and isinstance(robust_scale, str):  # 'auto'
            robust_scale = pose_graph.auto_robust_scale(graph, iterations=gn_iterations,
                                                        robust_edges=robust_mask)
            print(f"robust scale (auto): {float(robust_scale):.4g}", file=sys.stderr)
    if two_pass:
        # Mapping scale: the two-pass welsch recipe (robust_solve).
        passes = 2 if args.scale_passes == "auto" else int(args.scale_passes)
        graph, costs, robust_scale, w = pose_graph.robust_solve(
            graph, robust_edges=robust_mask, iterations=gn_iterations,
            robust_scale=robust_scale, scale_passes=passes)
        print(f"robust scale (two-pass welsch, {n_loop} closures): {float(robust_scale):.4g}",
              file=sys.stderr)
    else:
        graph, costs = pose_graph.optimize(graph, iterations=gn_iterations,
                                           robust=args.robust_kernel,
                                           robust_scale=robust_scale, robust_edges=robust_mask)
    print(f"pose-graph cost: {float(costs[0]):.6g} -> {float(costs[-1]):.6g}", file=sys.stderr)
    if args.robust_kernel != "none" and loop_edges is not None:
        if not two_pass:
            w, _ = pose_graph.robust_edge_weights(graph, args.robust_kernel, robust_scale,
                                                  robust_edges=robust_mask)
        loop_w = w.cpu().numpy()[-n_loop:]
        print(f"loop-closure robust weights: {np.round(loop_w, 4).tolist()}", file=sys.stderr)
    return graph.poses


def cmd_graph(args):
    """Optimize a g2o pose graph (the analogue of the ``g2o`` binary): load,
    robust-solve on the device, report chi², write back."""
    from . import pose_graph
    from .io import read_g2o, write_g2o, write_tum

    device = _device(args.platform)
    graph = read_g2o(args.input, device=device)
    print(f"loaded {graph.num_nodes} vertices, {graph.num_edges} edges "
          f"({'matrix' if graph.sqrt_information is not None else 'scalar'} information)",
          file=sys.stderr)
    if args.outlier_protocol:
        # The Vertigo-style evaluation (robustness.run_protocol): one JSON
        # record per (mode, rate, kernel).
        from . import robustness

        recs = robustness.run_protocol(
            graph, rates=tuple(float(r) for r in args.outlier_rates.split(",")),
            modes=tuple(args.outlier_modes.split(",")),
            kernels=tuple(args.protocol_kernels.split(",")), iterations=args.iterations,
            solver=args.solver, cg_iterations=args.cg_iterations, seed=args.protocol_seed,
            scale_passes=args.scale_passes)
        for rec in recs:
            print(json.dumps(rec))
        return
    robust_mask = None
    robust_scale = args.robust_scale
    if args.robust_kernel != "none" and args.robust_min_separation > 0:
        span = graph.edges_ij[:, 1] - graph.edges_ij[:, 0]
        robust_mask = (span < 0) | (span.abs() >= args.robust_min_separation)
    if args.robust_kernel != "none" and args.scale_passes > 1:
        opt, costs, scale, _ = pose_graph.robust_solve(
            graph, kernel=args.robust_kernel, robust_edges=robust_mask,
            iterations=args.iterations, solver=args.solver, cg_iterations=args.cg_iterations,
            robust_scale=args.robust_scale, scale_passes=args.scale_passes)
        print(f"robust scale (pass {args.scale_passes}): {scale:.4g}", file=sys.stderr)
        # robust_solve's cost trace belongs to its last pass; report the
        # true chi² at the input poses so chi2_initial keeps its meaning.
        r0 = pose_graph.edge_residuals(graph, graph.poses)
        costs = torch.cat([(r0 * r0).sum()[None], costs[1:]])
    else:
        if robust_mask is not None and isinstance(robust_scale, str):  # 'auto'
            robust_scale = pose_graph.auto_robust_scale(
                graph, iterations=args.iterations, solver=args.solver,
                robust_edges=robust_mask)
            print(f"robust scale (auto): {float(robust_scale):.4g}", file=sys.stderr)
        opt, costs = pose_graph.optimize(
            graph, iterations=args.iterations, solver=args.solver,
            cg_iterations=args.cg_iterations, robust=args.robust_kernel,
            robust_scale=robust_scale, robust_edges=robust_mask)
    print(f"chi2: {float(costs[0]):.6g} -> {float(costs[-1]):.6g} "
          f"({args.iterations} GN iterations, solver {args.solver})", file=sys.stderr)
    if args.output:
        write_g2o(args.output, opt)
        print(f"wrote {args.output}", file=sys.stderr)
    if args.tum:
        write_tum(args.tum, opt.poses)
        print(f"wrote {args.tum}", file=sys.stderr)
    print(json.dumps({
        "vertices": graph.num_nodes,
        "edges": graph.num_edges,
        "chi2_initial": float(costs[0]),
        "chi2_final": float(costs[-1]),
    }))


def cmd_methods(args):
    from .methods import registered_methods

    del args
    for dim in (2, 3):
        print(f"{dim}D: " + ", ".join(registered_methods(dim)))


def main(argv=None):
    from . import __version__

    parser = argparse.ArgumentParser(
        prog="icp-tpu-torch", description="scan matching on a CUDA card (PyTorch)"
    )
    parser.add_argument("--version", action="version", version=f"icp-tpu-torch {__version__}")
    parser.add_argument(
        "--platform", choices=["cpu", "gpu"], default="gpu",
        help="gpu (default) runs on the CUDA card and fails without one; cpu runs on the host",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_reg = sub.add_parser("register", help="register one scan/cloud pair")
    p_reg.add_argument("-S", "--src", required=True,
                       help="source scan CSV/.conf (or PLY with --ply)")
    p_reg.add_argument("-D", "--dst", required=True, help="destination scan CSV/.conf (or PLY)")
    p_reg.add_argument("-m", "--method", default="vanilla")
    p_reg.add_argument("-c", "--config", nargs="*", help="method config key=value")
    p_reg.add_argument("--ply", action="store_true", help="inputs are 3D PLY clouds")
    p_reg.add_argument(
        "--sor", action="store_true",
        help="statistical outlier removal on both clouds before registration",
    )
    p_reg.add_argument(
        "--multiscale", action="store_true",
        help="coarse-to-fine pyramid (decimate 4x, then full resolution)",
    )
    p_reg.add_argument(
        "--coarse", action="store_true",
        help="global rotation initializer: bearing-histogram correlation (2D) "
        "or principal-axes candidates (3D)",
    )
    p_reg.add_argument(
        "--exact-capacity", action="store_true",
        help="pad clouds to a multiple of 8 instead of power-of-two buckets",
    )
    p_reg.add_argument("--json", action="store_true")
    p_reg.add_argument("--out-ply", help="write transformed source cloud")
    _add_driver_flags(p_reg)
    p_reg.set_defaults(fn=cmd_register)

    p_view = sub.add_parser("view", help="render registration frames (offline LidarView)")
    p_view.add_argument("-S", "--src", required=True)
    p_view.add_argument("-D", "--dst", required=True)
    p_view.add_argument("-m", "--method", default="vanilla")
    p_view.add_argument("-c", "--config", nargs="*")
    p_view.add_argument("--basic-mode", action="store_true", help="light background")
    p_view.add_argument("--view-conf",
                        help="display conf file (view.conf format: window size, scale)")
    p_view.add_argument("-l", "--log", action="store_true", help="per-iteration debug dump")
    p_view.add_argument("--out", default="view_frames")
    p_view.add_argument("--iterations", type=int, default=20)
    p_view.add_argument("--every", type=int, default=1)
    p_view.add_argument("--animate",
                        help="assemble frames into .gif or interactive .html (SPACE run / I "
                        "step / D dump, like the SDL viewer)")
    p_view.add_argument("--fps", type=int, default=5)
    p_view.set_defaults(fn=cmd_view)

    p_bench = sub.add_parser("bench", help="benchmark registered methods on example scans")
    p_bench.add_argument("--methods", nargs="*", help="default: all registered 2D methods")
    p_bench.add_argument("--scans", nargs="*", type=int, default=[1, 2, 3])
    p_bench.add_argument("--invocations", type=int, default=10)
    p_bench.add_argument("--data-dir", default=DATA_DIR,
                         help="directory with scan1/, scan2/, ... (default: the repository's "
                         "ex_data)")
    p_bench.add_argument("-c", "--config", nargs="*")
    p_bench.add_argument("--batch", type=int, default=0,
                         help="also measure batched throughput at this many pairs/invocation")
    p_bench.set_defaults(fn=cmd_bench)

    p_odo = sub.add_parser("odometry", help="chain a scan sequence into a trajectory")
    p_odo.add_argument("--scans", nargs="+", required=True,
                       help="ordered scan CSVs or .conf sweeps (or PLYs with --ply)")
    p_odo.add_argument("--ply", action="store_true", help="scans are 3D PLY clouds")
    p_odo.add_argument(
        "--exact-capacity", action="store_true",
        help="pad to the largest scan rounded up to 8 instead of its power-of-two bucket",
    )
    p_odo.add_argument("-m", "--method", default="trimmed")
    p_odo.add_argument("-c", "--config", nargs="*", help="method config key=value")
    p_odo.add_argument(
        "--coarse", action="store_true",
        help="seed every pair with the global initializer (sharp turns)",
    )
    p_odo.add_argument("--multiscale", action="store_true",
                       help="register pairs through the coarse-to-fine pyramid")
    p_odo.add_argument(
        "--scan-to-map", action="store_true",
        help="register each scan against an aggregated voxel map (less drift)",
    )
    p_odo.add_argument("--voxel-size", type=float, default=0.1)
    p_odo.add_argument("--map-capacity", type=int, default=8192)
    p_odo.add_argument(
        "--device-map", action="store_true",
        help="(--scan-to-map) keep the map on the device at fixed shapes instead of "
        "merging it on the host",
    )
    p_odo.add_argument(
        "--eval", metavar="GT_TUM",
        help="evaluate the trajectory against a TUM ground-truth file (one line per "
        "scan): one more JSON record with the Umeyama-aligned ATE and delta-1 RPE",
    )
    p_odo.add_argument("--optimize", action="store_true", help="pose-graph refine")
    p_odo.add_argument(
        "--gn-iterations", type=int, default=None,
        help="Gauss-Newton iterations for --optimize (default 10; 30 when --robust-kernel "
        "is set: the GNC anneal needs the budget)",
    )
    p_odo.add_argument("--loop-radius", type=float, default=0.0,
                       help="detect and register loop closures within this pose radius")
    p_odo.add_argument("--loop-min-separation", type=int, default=10)
    p_odo.add_argument("--loop-weight", type=float, default=10.0)
    p_odo.add_argument(
        "--loop-max-cost", type=float, default=None,
        help="reject loop closures whose registration cost exceeds this (one bad closure "
        "can corrupt the optimized trajectory)",
    )
    p_odo.add_argument(
        "--loop-coarse", action="store_true",
        help="seed closure registrations with the global initializer (large drift)",
    )
    p_odo.add_argument(
        "--loop-descriptor", type=float, default=None, metavar="RANGE",
        help="detect loop closures by Scan Context appearance instead of pose radius "
        "(RANGE = sensor range, the descriptor's radial extent); immune to pose drift, and "
        "each closure is seeded with the descriptor's yaw estimate",
    )
    p_odo.add_argument(
        "--descriptor-max-distance", type=float, default=0.2,
        help="Scan Context distance acceptance threshold for --loop-descriptor",
    )
    p_odo.add_argument(
        "--online", action="store_true",
        help="streaming mode: scan-by-scan OnlineSlam (periodic robust loop closure, live "
        "re-anchoring) instead of the offline batch pipeline",
    )
    p_odo.add_argument(
        "--pipelined", action="store_true",
        help="(--online) launch each scan's step before the previous scan's promotion is "
        "read: records stream with one scan of latency",
    )
    p_odo.add_argument(
        "--async-refine", action="store_true",
        help="(--online) solve loop-closure refinements on a worker thread: the solve "
        "leaves the add_scan path and its exact left-compose correction lands at the first "
        "scan after it finishes",
    )
    p_odo.add_argument("--loop-every", type=int, default=8,
                       help="(--online) refine every N keyframes")
    p_odo.add_argument("--keyframe-translation", type=float, default=0.5)
    p_odo.add_argument("--keyframe-angle", type=float, default=0.1)
    p_odo.add_argument("--odometry-weight", type=float, default=1.0,
                       help="graph information weight of odometry edges (~1/sigma^2; raise "
                       "it when the front end tracks well)")
    p_odo.add_argument("--render", help="write a trajectory/map PNG to this path")
    p_odo.add_argument("--save", help="checkpoint the trajectory poses (.npz)")
    p_odo.add_argument(
        "--robust-kernel", default="none",
        choices=["none", "huber", "cauchy", "welsch", "gnc_gm"],
        help="robust loss on the loop-closure edges: down-weights wrong closures by their "
        "graph inconsistency; gnc_gm = graduated non-convexity",
    )
    p_odo.add_argument(
        "--closure-information", action="store_true",
        help="anisotropic closure edges: per-closure information from the target scan's "
        "surface geometry (Censi form)",
    )
    p_odo.add_argument(
        "--robust-scale", default="auto", type=lambda s: s if s == "auto" else float(s),
        help="inlier threshold for --robust-kernel in plain residual units "
        "(meters+radians); 'auto' derives it from an L2 pre-solve",
    )
    p_odo.add_argument(
        "--scale-passes", default="auto", type=lambda s: s if s == "auto" else int(s),
        help="robust-scale re-estimation passes: 'auto' switches to the two-pass welsch "
        "solve (pose_graph.robust_solve) at --mapping-threshold closures; 1 forces one pass",
    )
    p_odo.add_argument(
        "--mapping-threshold", type=int, default=12,
        help="accepted-closure count at which --scale-passes 'auto' switches to two passes",
    )
    _add_driver_flags(p_odo)
    p_odo.set_defaults(fn=cmd_odometry)

    p_g = sub.add_parser("graph", help="optimize a g2o pose graph (robust kernels, PCG)")
    p_g.add_argument("input", help="input .g2o file (SE2 or SE3:QUAT)")
    p_g.add_argument("-o", "--output", help="write the optimized graph (.g2o)")
    p_g.add_argument("--tum", help="also write the optimized trajectory (TUM)")
    p_g.add_argument("--iterations", type=int, default=30)
    p_g.add_argument("--solver", default="auto", choices=["auto", "dense", "cg", "pcg"])
    p_g.add_argument("--cg-iterations", type=int, default=50)
    p_g.add_argument("--robust-kernel", default="none",
                     choices=["none", "huber", "cauchy", "welsch", "gnc_gm"])
    p_g.add_argument("--robust-scale", default="auto",
                     type=lambda s: s if s == "auto" else float(s))
    p_g.add_argument(
        "--robust-min-separation", type=int, default=2,
        help="edges spanning fewer than this many ids stay quadratic (odometry-like); the "
        "kernel acts on the rest (loop-like)",
    )
    p_g.add_argument(
        "--scale-passes", type=int, default=1,
        help="robust-scale re-estimation passes (pose_graph.robust_solve); 2 = one bounded "
        "re-estimate at the robust solution, the multi-outlier recipe",
    )
    p_g.add_argument(
        "--outlier-protocol", action="store_true",
        help="run the outlier-injection evaluation on this graph instead of solving it: "
        "per (mode, rate, kernel) closure precision/recall and ATE vs the clean oracle, "
        "one JSON line each",
    )
    p_g.add_argument("--outlier-rates", default="0.1,0.2,0.3")
    p_g.add_argument("--outlier-modes", default="random,clustered")
    p_g.add_argument("--protocol-kernels", default="none,cauchy,welsch,gnc_gm")
    p_g.add_argument("--protocol-seed", type=int, default=0)
    p_g.set_defaults(fn=cmd_graph)

    p_m = sub.add_parser("methods", help="list registered methods")
    p_m.set_defaults(fn=cmd_methods)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
