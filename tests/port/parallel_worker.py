"""One rank of the gloo cluster behind ``test_torch_parallel.py``.

Launched once per test session on every rank of an 8-process cluster, with
the rendezvous in the environment as ``torchrun`` sets it (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), so that the ranks come up through
``parallel.initialize_multihost()``::

    python tests/port/parallel_worker.py INPUTS.npz OUT_DIR

Each rank runs every case of :data:`CASES` in order on the CPU, float64
unless the case says otherwise, on the inputs the test process wrote (numpy
arrays from seeds; the graphs' in ``graphs.npz`` beside, written while the
cluster runs), and writes ``OUT_DIR/rank{r}.npz`` (the case's arrays as
``case/name``) and ``OUT_DIR/rank{r}.json`` (the traceback of each case that
raised).  A rank that raised in a case leaves the others waiting in that
case's next collective until the process group's timeout, so a failure ends
as failures, not as a hang.
"""

import datetime
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TIMEOUT_S = 60
WORLD = 8


def _cloud(icp, points, count, dtype=torch.float64):
    return icp.PointCloud(torch.as_tensor(points, dtype=dtype),
                          torch.as_tensor(count, dtype=torch.int32))


def _blocks(par, mesh, *arrays):
    """Each array's block along the points axis (axis 0)."""
    layout = par.Layout(mesh, (par.POINT_AXIS,))
    return [par.local_block(torch.as_tensor(a), layout) for a in arrays]


def _nn_case(par, mesh, inp, prefix, ring):
    q, t, mask = inp[f"{prefix}/q"], inp[f"{prefix}/t"], inp.get(f"{prefix}/mask")
    t_blk, = _blocks(par, mesh, t)
    m_blk = None if mask is None else _blocks(par, mesh, mask)[0]
    if ring:
        q_blk, = _blocks(par, mesh, q)
        sq, idx = par.ring_nearest_neighbors(q_blk, t_blk, m_blk, mesh)
        group = par.mesh.axis_group(mesh, par.POINT_AXIS)
        sq, idx = par.comm.all_gather(sq, group), par.comm.all_gather(idx, group)
    else:
        sq, idx = par.sharded_nearest_neighbors(torch.as_tensor(q), t_blk, m_blk, mesh)
    return {"sq": sq, "idx": idx}


def _converge_case(icp, par, mesh, inp, prefix, method, cfg, shard_points, dtype=torch.float64):
    src = _cloud(icp, inp[f"{prefix}/a"], inp[f"{prefix}/count"], dtype)
    tgt = _cloud(icp, inp[f"{prefix}/b"], inp[f"{prefix}/count"], dtype)
    guess = icp.identity(src.dim, (src.points.shape[0],), dtype=dtype, device="cpu")
    fn = par.make_sharded_converge_fn(method, cfg, mesh, shard_points=shard_points)
    result, state = fn(*par.shard_batch((src, tgt, guess), mesh, shard_points))
    return {"iters": result.iteration_count, "cost": result.cost,
            "rot": result.transform.rotation, "trans": result.transform.translation,
            "local_rot": state.transform.rotation, "local_trans": state.transform.translation}


def _big_cloud_case(icp, par, mesh, inp, prefix, **kw):
    a, b = inp[f"{prefix}/a"], inp[f"{prefix}/b"]
    a_blk, am_blk, b_blk, bm_blk = _blocks(par, mesh, a, np.ones(len(a), bool), b,
                                           np.ones(len(b), bool))
    tf, iters, mean_nn = par.big_cloud_converge(
        a_blk, am_blk, b_blk, bm_blk, icp.identity(a.shape[1], dtype=torch.float64, device="cpu"),
        mesh, **kw)
    return {"rot": tf.rotation, "trans": tf.translation, "iters": torch.tensor(iters),
            "mean_nn": mean_nn}


def _graph(convert, inp, prefix):
    if f"{prefix}/weights" not in inp:
        # The test process writes the graphs after it started the cluster.
        path = os.path.join(os.path.dirname(inp["__path__"]), "graphs.npz")
        deadline = time.monotonic() + TIMEOUT_S
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{path} was not written")
            time.sleep(0.05)
        with np.load(path) as f:
            inp.update(f)
    fields = {"poses": {"rotation": inp[f"{prefix}/poses_rotation"],
                        "translation": inp[f"{prefix}/poses_translation"]},
              "measurements": {"rotation": inp[f"{prefix}/measurements_rotation"],
                               "translation": inp[f"{prefix}/measurements_translation"]},
              "edges_ij": inp[f"{prefix}/edges_ij"], "weights": inp[f"{prefix}/weights"],
              "sqrt_information": inp.get(f"{prefix}/sqrt_information")}
    return convert.pose_graph_from_numpy(fields, device="cpu")


def _pose_graph_case(icp, par, meshes, inp, prefix, iterations, **kw):
    graph = _graph(icp.convert, inp, prefix)
    sharded = icp.pose_graph.shard_over_edges(graph, meshes[8, 1])
    opt, costs = icp.pose_graph.optimize(sharded, iterations=iterations, **kw)
    return {"trans": opt.poses.translation, "rot": opt.poses.rotation, "costs": costs}


def _robust_case(icp, par, meshes, inp, prefix, solve, **kw):
    """``robust_solve`` / ``robust_solve_fused`` / ``auto_robust_scale`` on
    the edge-sharded graph, with this rank's block of the closure mask; the
    per-edge weights gathered back whole."""
    mesh = meshes[8, 1]
    graph = _graph(icp.convert, inp, prefix)
    sharded = icp.pose_graph.shard_over_edges(graph, mesh)
    closures = torch.as_tensor(inp[f"{prefix}/robust_edges"])
    closures = torch.cat([closures, closures.new_zeros(sharded.num_edges * WORLD - len(closures))])
    closures = par.local_block(closures, par.Layout(mesh, (par.DATA_AXIS,)))
    fn = getattr(icp.pose_graph, solve)
    if solve == "auto_robust_scale":
        return {"scale": fn(sharded, robust_edges=closures, **kw)}
    opt, costs, scale, weights = fn(sharded, robust_edges=closures, **kw)
    group = par.mesh.axis_group(mesh, par.DATA_AXIS)
    return {"trans": opt.poses.translation, "rot": opt.poses.rotation, "costs": costs,
            "scale": torch.as_tensor(scale, dtype=torch.float64),
            "weights": par.comm.all_gather(weights, group)}


def _divisibility(icp, par, meshes):
    """1 for each call that raised the divisibility error, on this rank."""
    mesh = meshes[1, 8]
    rank = torch.distributed.get_rank()
    pts = torch.zeros((8 + (rank == 0), 3), dtype=torch.float64)  # unequal blocks
    mask = torch.ones(len(pts), dtype=torch.bool)
    calls = [
        lambda: par.local_block(torch.zeros(12, 3), par.Layout(mesh, (par.POINT_AXIS,))),
        lambda: par.big_cloud_converge(pts, mask, pts, mask, icp.identity(3, device="cpu"),
                                       mesh, max_iterations=2),
        lambda: par.ring_nearest_neighbors(pts, pts, mask, mesh),
        lambda: par.shard_batch(
            (icp.PointCloud(torch.zeros(6, 8, 2), torch.zeros(6, dtype=torch.int32)),) * 2
            + (icp.identity(2, (6,), device="cpu"),), meshes[8, 1]),
    ]
    raised = []
    for call in calls:
        try:
            call()
            raised.append(0)
        except ValueError as err:
            raised.append(int("divis" in str(err) or "must divide" in str(err)))
    return {"raised": torch.tensor(raised)}


def _cases(icp, par):
    trimmed = icp.from_method("trimmed", 2, icp.Config(overlap_rate=0.9))
    converge_cfg = icp.DriverConfig(max_iterations=25, angle_tolerance=1e-3,
                                    translation_tolerance=1e-2)
    feature = icp.from_method("feature_aware", 2, icp.Config(overlap_rate=1.0))
    feature_cfg = icp.DriverConfig(max_iterations=20, angle_tolerance=1e-6,
                                   translation_tolerance=1e-6)
    host = icp.from_method("trimmed", 2, icp.Config(overlap_rate=1.0))
    host_cfg = icp.DriverConfig(max_iterations=30, angle_tolerance=1e-4,
                                translation_tolerance=1e-4)
    svd = dict(solver="svd")
    return {
        "sharded_nn": lambda m, i: _nn_case(par, m[1, 8], i, "nn", ring=False),
        "ring_nn": lambda m, i: _nn_case(par, m[1, 8], i, "nn", ring=True),
        "sharded_nn_ties": lambda m, i: _nn_case(par, m[1, 8], i, "ties", ring=False),
        "ring_nn_ties": lambda m, i: _nn_case(par, m[1, 8], i, "ring_ties", ring=True),
        "sharded_nn_padded": lambda m, i: _nn_case(par, m[1, 8], i, "padded", ring=False),
        "ring_nn_padded": lambda m, i: _nn_case(par, m[1, 8], i, "padded", ring=True),
        "converge_8x1": lambda m, i: _converge_case(icp, par, m[8, 1], i, "converge", trimmed,
                                                    converge_cfg, False),
        "converge_4x2": lambda m, i: _converge_case(icp, par, m[4, 2], i, "converge", trimmed,
                                                    converge_cfg, True),
        "feature_aware_2x4": lambda m, i: _converge_case(icp, par, m[2, 4], i, "feature",
                                                         feature, feature_cfg, True),
        "big_cloud_ungated": lambda m, i: _big_cloud_case(icp, par, m[1, 8], i, "big3d",
                                                          max_iterations=10, **svd),
        "big_cloud_gated": lambda m, i: _big_cloud_case(icp, par, m[1, 8], i, "big3d",
                                                        max_iterations=10, max_distance=3.0,
                                                        **svd),
        "big_cloud_2d": lambda m, i: _big_cloud_case(
            icp, par, m[1, 8], i, "big2d", max_iterations=15, angle_tolerance=1e-6,
            translation_tolerance=1e-6),
        "big_cloud_tolerance": lambda m, i: _big_cloud_case(
            icp, par, m[1, 8], i, "bigtol", max_iterations=100, angle_tolerance=1e-6,
            translation_tolerance=1e-6, **svd),
        "big_cloud_gather": lambda m, i: _big_cloud_case(icp, par, m[1, 8], i, "bigring",
                                                         max_iterations=8, **svd),
        "big_cloud_ring": lambda m, i: _big_cloud_case(icp, par, m[1, 8], i, "bigring",
                                                       max_iterations=8, target_mode="ring",
                                                       **svd),
        "pose_graph_pcg": lambda m, i: _pose_graph_case(icp, par, m, i, "graph", 6,
                                                        solver="pcg"),
        "pose_graph_information": lambda m, i: _pose_graph_case(icp, par, m, i, "info", 5,
                                                                solver="pcg"),
        "pose_graph_dense_gnc": lambda m, i: _pose_graph_case(
            icp, par, m, i, "info", 8, solver="dense", robust="gnc_gm", robust_scale="auto"),
        "pose_graph_cg_welsch": lambda m, i: _pose_graph_case(
            icp, par, m, i, "info", 5, solver="cg", cg_iterations=20, robust="welsch",
            robust_scale=0.5),
        "robust_solve": lambda m, i: _robust_case(
            icp, par, m, i, "info", "robust_solve", kernel="welsch", iterations=6, solver="pcg"),
        "robust_solve_fused": lambda m, i: _robust_case(
            icp, par, m, i, "info", "robust_solve_fused", kernel="gnc_gm", iterations=6,
            solver="dense"),
        "auto_scale_max": lambda m, i: _robust_case(
            icp, par, m, i, "info", "auto_robust_scale", iterations=6, solver="pcg", rule="max"),
        "divisibility": lambda m, i: _divisibility(icp, par, m),
        "multihost": lambda m, i: _converge_case(icp, par, m[8, 1], i, "multihost", host,
                                                 host_cfg, False, dtype=torch.float32),
    }


def main() -> int:
    inputs_path, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    import icp_tpu_torch as icp
    from icp_tpu_torch import parallel as par

    rank = int(os.environ["RANK"])
    par.initialize_multihost(backend="gloo", timeout=datetime.timedelta(seconds=TIMEOUT_S))
    meshes = {shape: par.make_mesh(*shape, device_type="cpu")
              for shape in ((1, 8), (8, 1), (4, 2), (2, 4))}
    with np.load(inputs_path) as f:
        inputs = dict(f, __path__=inputs_path)
    results, errors = {}, {}
    for name, case in _cases(icp, par).items():
        try:
            for key, value in case(meshes, inputs).items():
                results[f"{name}/{key}"] = value.detach().cpu().numpy()
        except Exception:  # a case's failure is reported with its traceback
            errors[name] = traceback.format_exc()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **results)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(errors, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
