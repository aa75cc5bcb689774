"""The parallel layer (``icp_tpu_torch.parallel``, ``pose_graph.shard_over_edges``)
against the JAX package's, on the CPU.

One 8-rank gloo cluster (``parallel_worker.py``, one process a rank, brought
up from ``torchrun``-style environment variables through
``parallel.initialize_multihost()``) runs every case of the module once, in
float64 on inputs this module draws from seeds with numpy.  It is started
before the JAX references are computed (on the 8-virtual-device CPU mesh of
``tests/conftest.py``, from the same arrays), so the two overlap.  Each case
is one test; a case that raised on a rank fails with that rank's traceback,
and a cluster that does not finish in time is killed and every case fails.

Tolerances are the JAX tests' (``tests/test_parallel.py``,
``tests/test_odometry_posegraph.py:558-578``, ``tests/test_covariance.py:156-185``):
NN indices equal and ``sq`` to rtol 1e-12; converge iteration counts equal,
rotations to 1e-12 and translations to 1e-9; big cloud rotations to 1e-9 and
translations to 1e-8, ring against gather to 1e-12; the edge-sharded PCG
poses to 1e-9 and its first cost to rtol 1e-12, which also hold the other
solvers, the robust kernels and the multi-pass robust solves (their scale to
rtol 1e-9, their weights to 1e-9) against JAX's unsharded functions.
"""

import concurrent.futures
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import traceback

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu as J
from icp_tpu import parallel as JP
from icp_tpu import pose_graph as JPG
from icp_tpu.ops.covariance import sqrt_information

import icp_tpu_torch as T
from icp_tpu_torch import parallel as TP

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parallel_worker.py")
WORLD = 8
CLUSTER_TIMEOUT_S = 240

NN_CASES = ("sharded_nn", "ring_nn", "sharded_nn_ties", "ring_nn_ties", "sharded_nn_padded",
            "ring_nn_padded")
CONVERGE_CASES = ("converge_8x1", "converge_4x2", "feature_aware_2x4")
BIG_CLOUD_CASES = ("big_cloud_ungated", "big_cloud_gated", "big_cloud_2d", "big_cloud_tolerance",
                   "big_cloud_gather", "big_cloud_ring")
GRAPH_CASES = ("pose_graph_pcg", "pose_graph_information", "pose_graph_dense_gnc",
               "pose_graph_cg_welsch")
ROBUST_CASES = ("robust_solve", "robust_solve_fused", "auto_scale_max")


def _rot_z(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _graph_arrays(prefix, graph) -> dict:
    out = {f"{prefix}/poses_rotation": graph.poses.rotation,
           f"{prefix}/poses_translation": graph.poses.translation,
           f"{prefix}/measurements_rotation": graph.measurements.rotation,
           f"{prefix}/measurements_translation": graph.measurements.translation,
           f"{prefix}/edges_ij": graph.edges_ij, f"{prefix}/weights": graph.weights}
    if graph.sqrt_information is not None:
        out[f"{prefix}/sqrt_information"] = graph.sqrt_information
    return {k: np.asarray(v) for k, v in out.items()}


def _inputs() -> dict:
    """Every case's inputs but the graphs', as numpy arrays (the JAX tests'
    draws and sizes)."""
    rng = np.random.default_rng(123)
    inp = {"nn/q": rng.uniform(-50, 50, (96, 3)), "nn/t": rng.uniform(-50, 50, (160, 3)),
           "nn/mask": rng.uniform(size=160) > 0.1}
    base = rng.uniform(-5, 5, (16, 2))
    near = base + rng.normal(0, 0.01, base.shape)
    inp.update({"ties/q": near, "ties/t": np.tile(base, (8, 1)),
                "ring_ties/q": np.tile(near, (8, 1)), "ring_ties/t": np.tile(base, (8, 1))})
    # Capacity 160 with 140 valid targets: the last of 8 blocks is all masked.
    inp.update({"padded/q": rng.uniform(-50, 50, (96, 3)),
                "padded/t": rng.uniform(-50, 50, (160, 3)),
                "padded/mask": np.arange(160) < 140})

    a_pts, b_pts, counts = np.zeros((8, 64, 2)), np.zeros((8, 64, 2)), np.zeros(8, np.int32)
    for k in range(8):
        n = 40 + k
        a = rng.uniform(-30, 30, (n, 2))
        ang = rng.uniform(-0.2, 0.2)
        c, s = np.cos(ang), np.sin(ang)
        a_pts[k, :n], counts[k] = a, n
        b_pts[k, :n] = a @ np.array([[c, s], [-s, c]]) + rng.uniform(-2, 2, 2)
    inp.update({"converge/a": a_pts, "converge/b": b_pts, "converge/count": counts})

    fa = rng.uniform(-20, 20, (4, 64, 2))
    inp.update({"feature/a": fa, "feature/b": fa + rng.uniform(-1, 1, (4, 1, 2)),
                "feature/count": np.full(4, 64, np.int32)})

    a3 = rng.uniform(-10, 10, (256, 3))
    inp.update({"big3d/a": a3, "big3d/b": np.concatenate(
        [a3 @ _rot_z(0.15).T + [1.0, -0.5, 0.2], rng.uniform(-10, 10, (64, 3))])})
    a2 = rng.uniform(-10, 10, (128, 2))
    c, s = np.cos(0.1), np.sin(0.1)
    inp.update({"big2d/a": a2, "big2d/b": np.concatenate(
        [a2 @ np.array([[c, s], [-s, c]]) + [0.5, -0.3], rng.uniform(-10, 10, (32, 2))])})
    at = rng.uniform(-10, 10, (128, 3))
    inp.update({"bigtol/a": at, "bigtol/b": at + [0.5, -0.2, 0.1]})
    ar = rng.uniform(-10, 10, (128, 3))
    inp.update({"bigring/a": ar, "bigring/b": np.concatenate(
        [ar + [0.8, -0.4, 0.2], rng.uniform(-10, 10, (32, 3))])})

    host = np.random.default_rng(0)  # tests/multihost_worker.py's draw
    ha = host.uniform(-30, 30, (8, 32, 2)).astype(np.float32)
    shift = host.uniform(-2, 2, (8, 1, 2)).astype(np.float32)
    inp.update({"multihost/a": ha, "multihost/b": ha + shift,
                "multihost/count": np.full(8, 32, np.int32), "multihost/shift": shift})
    return inp


def _graphs() -> tuple[dict, np.ndarray]:
    """The JAX tests' two graphs (``test_pose_graph_sharded_vs_single``,
    ``test_pad_and_shard_with_information``) and the square's closure mask
    (its one true and one wrong closure, the robust edges)."""
    from tests.test_odometry_posegraph import _random_graph
    from tests.test_robust_posegraph import _square_loop_graph

    graph = _random_graph(np.random.default_rng(123), t_steps=150, n_loops=30)
    square, _, _, n_odo = _square_loop_graph(np.random.default_rng(123))
    info = jnp.stack([jnp.eye(3, dtype=square.poses.dtype) * (1.0 + 0.1 * k)
                      for k in range(square.num_edges)])
    return ({"graph": graph,
             "info": dataclasses.replace(square, sqrt_information=sqrt_information(info))},
            np.arange(square.num_edges) >= n_odo)


def _jax_references(inp, graphs, closures) -> dict:
    """Each case's result from the JAX package's parallel function (a
    traceback string where it raised)."""
    meshes = {(d, p): JP.make_mesh(data=d, points=p) for d, p in ((1, 8), (8, 1), (4, 2), (2, 4))}
    one = jnp.ones

    def nn(prefix, fn):
        mask = inp.get(f"{prefix}/mask")
        sq, idx = fn(jnp.asarray(inp[f"{prefix}/q"]), jnp.asarray(inp[f"{prefix}/t"]),
                     None if mask is None else jnp.asarray(mask), meshes[1, 8])
        return {"sq": sq, "idx": idx}

    def converge(prefix, name, cfg_kw, drv_kw, mesh, shard_points):
        b = inp[f"{prefix}/a"].shape[0]
        count = jnp.asarray(inp[f"{prefix}/count"])
        src = J.PointCloud(jnp.asarray(inp[f"{prefix}/a"]), count)
        tgt = J.PointCloud(jnp.asarray(inp[f"{prefix}/b"]), count)
        guess = J.identity(2, (b,), dtype=np.float64)
        fn = JP.make_sharded_converge_fn(J.from_method(name, 2, J.Config(**cfg_kw)),
                                         J.DriverConfig(**drv_kw), meshes[mesh], shard_points)
        got, _ = fn(*JP.shard_batch((src, tgt, guess), meshes[mesh], shard_points))
        return {"iters": got.iteration_count, "rot": got.transform.rotation,
                "trans": got.transform.translation}

    def big(prefix, **kw):
        a, b = inp[f"{prefix}/a"], inp[f"{prefix}/b"]
        tf, iters, mean_nn = JP.big_cloud_converge(
            jnp.asarray(a), one(len(a), dtype=bool), jnp.asarray(b), one(len(b), dtype=bool),
            J.identity(a.shape[1], dtype=np.float64), meshes[1, 8], **kw)
        return {"rot": tf.rotation, "trans": tf.translation, "iters": iters, "mean_nn": mean_nn}

    def graph(prefix, iterations, **kw):
        opt, costs = JPG.optimize(graphs[prefix], iterations=iterations, **kw)
        return {"trans": opt.poses.translation, "costs": costs}

    def robust(solve, **kw):
        fn = getattr(JPG, solve)
        if solve == "auto_robust_scale":
            return {"scale": fn(graphs["info"], robust_edges=jnp.asarray(closures), **kw)}
        opt, costs, scale, weights = fn(graphs["info"], robust_edges=jnp.asarray(closures), **kw)
        return {"trans": opt.poses.translation, "costs": costs, "scale": scale,
                "weights": weights}

    converge_drv = dict(max_iterations=25, angle_tolerance=1e-3, translation_tolerance=1e-2)
    feature_drv = dict(max_iterations=20, angle_tolerance=1e-6, translation_tolerance=1e-6)
    tol = dict(angle_tolerance=1e-6, translation_tolerance=1e-6)
    jobs = {
        "sharded_nn": lambda: nn("nn", JP.sharded_nearest_neighbors),
        "ring_nn": lambda: nn("nn", JP.ring_nearest_neighbors),
        "sharded_nn_ties": lambda: nn("ties", JP.sharded_nearest_neighbors),
        "ring_nn_ties": lambda: nn("ring_ties", JP.ring_nearest_neighbors),
        "sharded_nn_padded": lambda: nn("padded", JP.sharded_nearest_neighbors),
        "ring_nn_padded": lambda: nn("padded", JP.ring_nearest_neighbors),
        "converge_8x1": lambda: converge("converge", "trimmed", {"overlap_rate": 0.9},
                                         converge_drv, (8, 1), False),
        "converge_4x2": lambda: converge("converge", "trimmed", {"overlap_rate": 0.9},
                                         converge_drv, (4, 2), True),
        "feature_aware_2x4": lambda: converge("feature", "feature_aware", {"overlap_rate": 1.0},
                                              feature_drv, (2, 4), True),
        "big_cloud_ungated": lambda: big("big3d", max_iterations=10, solver="svd"),
        "big_cloud_gated": lambda: big("big3d", max_iterations=10, max_distance=3.0,
                                       solver="svd"),
        "big_cloud_2d": lambda: big("big2d", max_iterations=15, **tol),
        "big_cloud_tolerance": lambda: big("bigtol", max_iterations=100, solver="svd", **tol),
        "big_cloud_gather": lambda: big("bigring", max_iterations=8, solver="svd"),
        "big_cloud_ring": lambda: big("bigring", max_iterations=8, solver="svd",
                                      target_mode="ring"),
        "pose_graph_pcg": lambda: graph("graph", 6, solver="pcg"),
        "pose_graph_information": lambda: graph("info", 5, solver="pcg"),
        "pose_graph_dense_gnc": lambda: graph("info", 8, solver="dense", robust="gnc_gm",
                                              robust_scale="auto"),
        "pose_graph_cg_welsch": lambda: graph("info", 5, solver="cg", cg_iterations=20,
                                              robust="welsch", robust_scale=0.5),
        "robust_solve": lambda: robust("robust_solve", kernel="welsch", iterations=6,
                                       solver="pcg"),
        "robust_solve_fused": lambda: robust("robust_solve_fused", kernel="gnc_gm",
                                             iterations=6, solver="dense"),
        # Not the CG solver: its L2 solve of this unanchored graph moves the
        # scale by 0.5% when the measurements move by 1e-14 (JAX and port).
        "auto_scale_max": lambda: robust("auto_robust_scale", iterations=6, solver="pcg",
                                         rule="max"),
    }
    def run(job):
        try:
            return {k: np.asarray(v) for k, v in job().items()}
        except Exception:  # reported by the case's own test
            return traceback.format_exc()

    # XLA compiles outside the interpreter lock: four at a time.
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        return dict(zip(jobs, pool.map(run, jobs.values())))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """``(port results by rank, errors by rank, JAX references, logs)``."""
    out = tmp_path_factory.mktemp("parallel")
    inp = _inputs()
    inputs_path = str(out / "inputs.npz")
    np.savez(inputs_path, **inp)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(WORLD), OMP_NUM_THREADS="1")
    logs = [open(out / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, WORKER, inputs_path, str(out)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    refs = {}
    try:
        # The graphs take seconds to draw in JAX: the cluster reaches its
        # graph cases last and waits for this file (written whole, renamed).
        graphs, closures = _graphs()
        graph_arrays = {k: v for name, g in graphs.items()
                        for k, v in _graph_arrays(name, g).items()}
        np.savez(out / "graphs.tmp.npz", **graph_arrays, **{"info/robust_edges": closures})
        os.replace(out / "graphs.tmp.npz", out / "graphs.npz")
        refs = _jax_references(inp, graphs, closures)
        deadline = time.monotonic() + CLUSTER_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass  # killed below: every case fails with the ranks' logs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    text = [(out / f"rank{r}.log").read_text() for r in range(WORLD)]
    ranks, errors = [], []
    for r in range(WORLD):
        if procs[r].returncode != 0 or not (out / f"rank{r}.npz").exists():
            ranks.append(None)
            errors.append({"*": f"rank {r} exited {procs[r].returncode}:\n{text[r][-3000:]}"})
            continue
        with np.load(out / f"rank{r}.npz") as f:
            ranks.append(dict(f))
        errors.append(json.loads((out / f"rank{r}.json").read_text()))
    return ranks, errors, refs, inp


def _case(cluster, name):
    """Rank 0's arrays of case ``name`` after every rank ran it cleanly."""
    ranks, errors, _, _ = cluster
    for r, err in enumerate(errors):
        if "*" in err or name in err:
            pytest.fail(f"rank {r}: {err.get(name, err.get('*'))}")
    return {k.split("/", 1)[1]: v for k, v in ranks[0].items() if k.startswith(f"{name}/")}


def _ref(cluster, name):
    ref = cluster[2].get(name)
    if not isinstance(ref, dict):
        pytest.fail(f"the JAX reference of {name} failed:\n{ref}")
    return ref


@pytest.mark.parametrize("name", NN_CASES)
def test_nn_matches_jax(cluster, name):
    got, want = _case(cluster, name), _ref(cluster, name)
    np.testing.assert_array_equal(got["idx"], want["idx"])
    if "ties" not in name:
        np.testing.assert_allclose(got["sq"], want["sq"], rtol=1e-12)


@pytest.mark.parametrize("name", CONVERGE_CASES)
def test_sharded_converge_matches_jax(cluster, name):
    got, want = _case(cluster, name), _ref(cluster, name)
    np.testing.assert_array_equal(got["iters"], want["iters"])
    np.testing.assert_allclose(got["rot"], want["rot"], atol=1e-12)
    np.testing.assert_allclose(got["trans"], want["trans"], atol=1e-9)


@pytest.mark.parametrize("name", BIG_CLOUD_CASES)
def test_big_cloud_matches_jax(cluster, name):
    got, want = _case(cluster, name), _ref(cluster, name)
    assert int(got["iters"]) == int(want["iters"])
    np.testing.assert_allclose(got["rot"], want["rot"], atol=1e-9)
    np.testing.assert_allclose(got["trans"], want["trans"], atol=1e-8)
    if name in ("big_cloud_ungated", "big_cloud_gated", "big_cloud_gather", "big_cloud_ring"):
        assert int(got["iters"]) == {"big_cloud_gather": 8, "big_cloud_ring": 8}.get(name, 10)
    if name == "big_cloud_tolerance":  # tests/test_parallel.py:148-169
        assert int(got["iters"]) < 100
        np.testing.assert_allclose(got["trans"], [0.5, -0.2, 0.1], atol=1e-6)
    if name == "big_cloud_2d":  # tests/test_parallel.py:172-194
        np.testing.assert_allclose(got["trans"], [0.5, -0.3], atol=1e-3)
    if name == "big_cloud_ring":  # ring against gather, tests/test_parallel.py:213-232
        gather = _case(cluster, "big_cloud_gather")
        for key in ("rot", "trans", "mean_nn"):
            np.testing.assert_allclose(got[key], gather[key], atol=1e-12)


@pytest.mark.parametrize("name", GRAPH_CASES)
def test_edge_sharded_pose_graph(cluster, name):
    """Every solver and robust kernel edge-sharded over 8 ranks against the
    JAX package's unsharded solve: the dense normal matrix's all-reduce, the
    CG matvec sums, gnc_gm's mu0 maximum and the auto scale's medians over
    the group."""
    got, want = _case(cluster, name), _ref(cluster, name)
    np.testing.assert_allclose(got["trans"], want["trans"], atol=1e-9)
    np.testing.assert_allclose(got["costs"][:1], want["costs"][:1], rtol=1e-12)


@pytest.mark.parametrize("name", ROBUST_CASES)
def test_edge_sharded_robust_solve(cluster, name):
    """The multi-pass robust solves and the legacy max-rule scale on the
    edge-sharded square (closures as the robust edges) against JAX's
    unsharded functions of the same names: ``robust_solve``'s gathered host
    statistics, ``robust_solve_fused``'s masked medians and quartile over
    the group, and ``auto_robust_scale(rule='max')``'s group maximum.  The
    gathered weights carry the padding's zero-weight edges at the end."""
    got, want = _case(cluster, name), _ref(cluster, name)
    np.testing.assert_allclose(got["scale"], want["scale"], rtol=1e-9)
    if name == "auto_scale_max":
        return
    np.testing.assert_allclose(got["trans"], want["trans"], atol=1e-9)
    np.testing.assert_allclose(got["costs"][:1], want["costs"][:1], rtol=1e-12)
    edges = len(want["weights"])
    np.testing.assert_allclose(got["weights"][:edges], want["weights"], atol=1e-9)


def test_divisibility_errors(cluster):
    """Capacities that do not divide the axis raise on every rank: a layout's
    cut, big_cloud's and the ring's unequal blocks, a batch over ``data``."""
    got = _case(cluster, "divisibility")
    assert got["raised"].tolist() == [1, 1, 1, 1]


def test_multihost_checksum(cluster):
    """``tests/multihost_worker.py``'s run, float32, data-sharded over 8 ranks
    brought up from the environment: every rank's checksum equal and within
    1e-2 of the planted shifts."""
    _case(cluster, "multihost")
    ranks, _, _, inp = cluster
    sums = [float(r["multihost/trans"].sum()) for r in ranks]
    assert len(set(sums)) == 1, sums
    assert abs(sums[0] - float(inp["multihost/shift"][:, 0, :].sum())) < 1e-2


@pytest.mark.parametrize("name", ("converge_4x2", "feature_aware_2x4"))
def test_points_group_lockstep(cluster, name):
    """Every rank returns the same batch, bit for bit, and the two (four)
    ranks of each points group hold the same lanes' method state."""
    _case(cluster, name)
    ranks = cluster[0]
    points = {"converge_4x2": 2, "feature_aware_2x4": 4}[name]
    for key in ("iters", "cost", "rot", "trans"):
        for r in range(1, WORLD):
            np.testing.assert_array_equal(ranks[r][f"{name}/{key}"], ranks[0][f"{name}/{key}"])
    for key in ("local_rot", "local_trans"):
        for r in range(WORLD):
            head = r - r % points
            np.testing.assert_array_equal(ranks[r][f"{name}/{key}"], ranks[head][f"{name}/{key}"])


def test_defaults_need_a_card():
    """No silent CPU mesh: the card's defaults raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.initialize_multihost()


def test_world_of_one(monkeypatch):
    """Without a rendezvous in the environment a process is a world of one:
    the mesh's shape errors, the sharded converge at (1, 1) equal to the
    driver's and accepted by the registrar, big_cloud's argument errors, and
    its unknown target mode."""
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    TP.initialize_multihost(backend="gloo")
    try:
        with pytest.raises(ValueError, match="not divisible by points=2"):
            TP.make_mesh(points=2, device_type="cpu")
        with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
            TP.make_mesh(data=2, device_type="cpu")
        mesh = TP.make_mesh(device_type="cpu")
        rng = np.random.default_rng(5)
        pts = rng.uniform(-10, 10, (64, 2))
        method = T.from_method("trimmed", 2)
        cfg = T.DriverConfig(max_iterations=20, angle_tolerance=1e-6, translation_tolerance=1e-6)
        fn = TP.make_sharded_converge_fn(method, cfg, mesh, shard_points=True)
        server = T.BatchingRegistrar(method, cfg, capacity=64, max_batch_size=4, device="cpu",
                                     dtype=np.float64, converge_fn=fn)
        try:
            served = server.register(pts, pts + [0.3, -0.2], timeout=60)
        finally:
            server.close()
        a = T.stack([T.from_points(pts, capacity=64, device="cpu")])
        b = T.stack([T.from_points(pts + [0.3, -0.2], capacity=64, device="cpu")])
        guess = T.identity(2, (1,), device="cpu")
        direct, _ = T.converge(method, a, b, guess, cfg)
        sharded, _ = fn(*TP.shard_batch((a, b, guess), mesh, True))
        assert torch.equal(sharded.transform.translation, direct.transform.translation)
        assert torch.equal(sharded.iteration_count, direct.iteration_count)
        np.testing.assert_allclose(served.translation, direct.transform.translation[0].numpy(),
                                   atol=1e-12)
        ones = torch.ones(64, dtype=torch.bool)
        with pytest.raises(ValueError, match="set together"):
            TP.big_cloud_converge(a.points[0], ones, b.points[0], ones, T.identity(2, device="cpu"),
                                  mesh, max_iterations=3, angle_tolerance=1e-3)
        with pytest.raises(ValueError, match="unknown target_mode"):
            TP.big_cloud_converge(a.points[0], ones, b.points[0], ones, T.identity(2, device="cpu"),
                                  mesh, max_iterations=3, target_mode="tree")
    finally:
        torch.distributed.destroy_process_group()
