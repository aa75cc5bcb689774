"""``icp_tpu_torch.pose_graph`` (and ``geometry.project_rotation``) against
the JAX package, float64 on the CPU, on graphs built by the JAX package
from seeded numpy draws and carried over with ``convert``:

* edge residuals and the ``(A, B)`` Jacobian blocks to 1e-10 (2D and 3D,
  with and without ``sqrt_information``);
* one GN step of each solver (dense, CG, PCG) to 1e-9;
* ``optimize`` cost traces (relative to the trace's largest cost) and poses
  to 1e-8 for each robust kernel x {dense, pcg} on the square scenario of
  ``tests/test_robust_posegraph.py`` (one true and one wrong closure, the
  auto scale), and on its SE(3) scenario; ``m600`` with pcg at 30
  iterations, chi² and poses to 1e-6;
* ``auto_robust_scale`` (both rules), the masked statistics, the robust
  weights, ``robust_solve`` (two passes, injected outliers) and
  ``robust_solve_fused`` against it;
* loop candidates exact (ties in row-major order, ``exclude``,
  ``max_candidates``), ``pad_edges``, ``graph_from_trajectory`` with
  ``loop_information``, ``register_loop_closures`` on the circle of
  ``tests/test_odometry_posegraph.py:204-262``;
* the ``early_exit_tol`` loop: equal to JAX while the damping is below its
  1e3 clamp, and the documented departure at the clamp.

Near convergence the solvers' roundoff differs between the two frameworks
(the blocks come from ``jvp`` here and ``jacfwd`` there), and CG amplifies
it on ill-conditioned systems, so the single-step CG case uses a graph on
which CG meets its tolerance.  The ``cuda``-marked twins run on the card in
float32 against the CPU float64 run; ``index_add_`` sums there in an order
that changes from run to run, so they hold by tolerance, never bit for bit.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T
from icp_tpu import geometry as jgeo
from icp_tpu import lie as jlie
from icp_tpu import pose_graph as jpg
from icp_tpu.ops import covariance as jcov
from icp_tpu_torch import convert, geometry, pose_graph as pg

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
M600 = os.path.join(REPO, "ex_data", "manhattan", "m600.g2o")
KERNELS = ("none", "huber", "cauchy", "welsch", "gnc_gm")


def _port(jgraph, device="cpu", dtype=None):
    return convert.pose_graph_from_numpy(dataclasses.asdict(jgraph), device=device,
                                         dtype=dtype)


def _mask(jmask, device="cpu"):
    return torch.as_tensor(np.array(jmask), device=device)


def _chain(twists, noise_twists, dim):
    """Ground truth from ``twists``, odometry measurements from the noisy
    ones, initial poses integrated from the measurements (JAX)."""
    gt = [jgeo.identity(dim, dtype=jnp.float64)]
    for k in range(len(twists)):
        gt.append(jgeo.compose(gt[-1], jlie.exp(jnp.asarray(twists[k]), dim)))
    meas = jlie.exp(jnp.asarray(noise_twists), dim)
    init = [gt[0]]
    for k in range(len(twists)):
        init.append(jgeo.compose(init[-1], jgeo.RigidTransform(meas.rotation[k],
                                                               meas.translation[k])))
    poses = jgeo.RigidTransform(jnp.stack([p.rotation for p in init]),
                                jnp.stack([p.translation for p in init]))
    return gt, meas, poses


def _loops(gt, pairs, offsets=None):
    rels = [jgeo.compose(jgeo.inverse(gt[a]), gt[b]) for a, b in pairs]
    trans = jnp.stack([r.translation for r in rels])
    if offsets is not None:
        trans = trans + jnp.asarray(offsets)
    return (jnp.asarray(pairs, dtype=jnp.int32),
            jgeo.RigidTransform(jnp.stack([r.rotation for r in rels]), trans))


def _random_graph(rng, t_steps, n_loops, dim=2, noise=0.02, info=False):
    """``tests/test_odometry_posegraph.py::_random_graph``; with ``info``,
    a random SPD information per edge."""
    d = jlie.dof(dim)
    twists = rng.uniform(-0.3, 0.3, (t_steps - 1, d))
    gt, meas, poses = _chain(twists, twists + rng.normal(0, noise, twists.shape), dim)
    li = rng.integers(0, t_steps - 1, n_loops)
    lj = np.minimum(li + rng.integers(2, t_steps, n_loops), t_steps - 1)
    edges, loop_meas = _loops(gt, list(zip(li, lj)))
    graph = jpg.graph_from_trajectory(poses, meas, loop_edges=edges,
                                      loop_measurements=loop_meas, loop_weight=10.0)
    if info:
        m = rng.normal(size=(graph.num_edges, d, d))
        spd = np.einsum("eij,ekj->eik", m, m) + d * np.eye(d)
        graph = dataclasses.replace(graph, sqrt_information=jcov.sqrt_information(
            jnp.asarray(spd)))
    return graph


def _square(rng, t_steps=17, drift=0.03):
    """``tests/test_robust_posegraph.py::_square_loop_graph``: a noisy
    square, one true closure and one 1.5 m wrong one; returns the graph and
    the loop mask."""
    side = (t_steps - 1) // 4
    twists = np.zeros((t_steps - 1, 3))
    twists[:, 0] = 1.0
    twists[side - 1::side, 2] = np.pi / 2
    gt, meas, poses = _chain(twists, twists + rng.normal(0, drift, twists.shape), 2)
    edges, loop_meas = _loops(gt, [[t_steps - 1, 0], [t_steps - 3, 2]],
                              offsets=[[0.0, 0.0], [1.5, 0.0]])
    graph = jpg.graph_from_trajectory(poses, meas, loop_edges=edges,
                                      loop_measurements=loop_meas, loop_weight=10.0)
    return graph, jnp.arange(graph.num_edges) >= t_steps - 1


def _se3_scenario(rng, t_steps=15):
    """``test_robust_rejects_bad_closure_se3``: a 3D chain, a true closure
    and one 1.2 m wrong one."""
    twists = rng.uniform(-0.25, 0.25, (t_steps - 1, 6))
    gt, meas, poses = _chain(twists, twists + rng.normal(0, 0.02, twists.shape), 3)
    edges, loop_meas = _loops(gt, [[t_steps - 1, 0], [t_steps - 3, 2]],
                              offsets=[[0.0, 0.0, 0.0], [0.0, 1.2, 0.0]])
    graph = jpg.graph_from_trajectory(poses, meas, loop_edges=edges,
                                      loop_measurements=loop_meas, loop_weight=10.0)
    return graph, jnp.arange(graph.num_edges) >= t_steps - 1


def _assert_poses(got, want, atol):
    np.testing.assert_allclose(got.poses.translation.cpu().numpy(),
                               np.asarray(want.poses.translation), atol=atol)
    np.testing.assert_allclose(got.poses.rotation.cpu().numpy(),
                               np.asarray(want.poses.rotation), atol=atol)


def _assert_trace(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("info", [False, True], ids=["scalar", "sqrt_information"])
def test_edge_linearization_matches_jax(rng, dim, info):
    jgraph = _random_graph(rng, t_steps=9, n_loops=3, dim=dim, info=info)
    graph = _port(jgraph)
    r, a, b = pg._edge_linearization(graph, graph.poses)
    jr, ja, jb = jax.jit(jpg._edge_linearization)(jgraph, jgraph.poses)
    for got, want in ((r, jr), (a, ja), (b, jb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)
    np.testing.assert_allclose(pg.edge_residuals(graph, graph.poses).numpy(),
                               np.asarray(jax.jit(jpg.edge_residuals)(jgraph, jgraph.poses)),
                               atol=1e-12)
    delta = rng.normal(0, 0.1, graph.num_nodes * jlie.dof(dim))
    np.testing.assert_allclose(pg._residual_of_delta(graph, torch.tensor(delta)).numpy(),
                               np.asarray(jax.jit(jpg._residual_of_delta)(jgraph,
                                                                          jnp.asarray(delta))),
                               atol=1e-12)
    np.testing.assert_allclose(pg._geometric_rn2(graph, graph.poses).numpy(),
                               np.asarray(jax.jit(jpg._geometric_rn2)(jgraph, jgraph.poses)),
                               atol=1e-12)


@pytest.mark.parametrize("solver", ["dense", "cg", "pcg"])
def test_one_solver_step_matches_jax(rng, solver):
    """Damping 1.0, at which unpreconditioned CG meets its tolerance on this
    graph (at 1e-6 it does not within 100 steps, and the two frameworks'
    last-bit differences grow to ~1e-6 m through its lost orthogonality)."""
    jgraph = _random_graph(rng, t_steps=12, n_loops=6)
    kw = dict(iterations=1, solver=solver, cg_iterations=100, damping=1.0)
    got, gc = pg.optimize(_port(jgraph), **kw)
    want, wc = jax.jit(lambda g: jpg.optimize(g, **kw))(jgraph)
    _assert_poses(got, want, 1e-9)
    _assert_trace(gc, wc, 1e-9)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_optimize_matches_jax(rng, kernel, solver):
    jgraph, jmask = _square(rng)
    got, gc = pg.optimize(_port(jgraph), iterations=30, solver=solver, robust=kernel,
                          robust_edges=_mask(jmask))
    want, wc = jax.jit(lambda g, m: jpg.optimize(g, iterations=30, solver=solver,
                                                 robust=kernel, robust_edges=m))(jgraph, jmask)
    assert gc.shape == (31,)
    _assert_trace(gc, wc, 1e-8)
    _assert_poses(got, want, 1e-8)


def test_optimize_se3_matches_jax(rng):
    jgraph, jmask = _se3_scenario(rng)
    graph, mask = _port(jgraph), _mask(jmask)
    got, gc = pg.optimize(graph, iterations=30, solver="dense", robust="gnc_gm",
                          robust_edges=mask)
    want, wc = jax.jit(lambda g, m: jpg.optimize(g, iterations=30, solver="dense",
                                                 robust="gnc_gm", robust_edges=m))(jgraph, jmask)
    _assert_trace(gc, wc, 1e-8)
    _assert_poses(got, want, 1e-8)
    # The wrong SE(3) closure is rejected, the true one kept.
    scale = pg.auto_robust_scale(graph, iterations=30, solver="dense", robust_edges=mask)
    w, _ = pg.robust_edge_weights(got, "gnc_gm", scale, robust_edges=mask)
    assert float(w[-1]) < 0.05 and float(w[-2]) > 0.8


def test_m600_pcg_matches_jax():
    jgraph = J.io.read_g2o(M600)
    got, gc = pg.optimize(T.io.read_g2o(M600, device="cpu"), iterations=30, solver="pcg",
                          cg_iterations=50)
    want, wc = jax.jit(lambda g: jpg.optimize(g, iterations=30, solver="pcg",
                                              cg_iterations=50))(jgraph)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-6)
    _assert_poses(got, want, 1e-6)
    assert float(gc[-1]) < 1e-3 * float(gc[0])


def test_auto_scale_weights_and_statistics_match_jax(rng):
    jgraph, jmask = _square(rng)
    graph, mask = _port(jgraph), _mask(jmask)
    for rule in ("median", "max"):
        got = pg.auto_robust_scale(graph, iterations=10, robust_edges=mask, rule=rule)
        want = jpg.auto_robust_scale(jgraph, iterations=10, robust_edges=jmask, rule=rule)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
    for kernel in KERNELS:
        w, rn = pg.robust_edge_weights(graph, kernel, 0.3, mu=2.0, robust_edges=mask)
        jw, jrn = jpg.robust_edge_weights(jgraph, kernel, 0.3, mu=2.0, robust_edges=jmask)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-12)
        np.testing.assert_allclose(rn.numpy(), np.asarray(jrn), atol=1e-12)
        rn2 = torch.tensor(rng.uniform(0, 1, 20))
        mu = torch.tensor(3.0, dtype=torch.float64)
        np.testing.assert_allclose(
            pg._robust_rho(rn2, kernel, 0.4, mu).numpy(),
            np.asarray(jpg._robust_rho(jnp.asarray(rn2.numpy()), kernel, 0.4, 3.0)),
            rtol=1e-13)
    vals = rng.uniform(0, 5, 31)
    for keep in (rng.uniform(size=31) > 0.4, np.zeros(31, bool), np.eye(1, 31, 7, dtype=bool)[0]):
        rn, kp = torch.tensor(vals), torch.tensor(keep)
        assert float(pg._masked_upper_median(rn, kp)) == float(
            jpg._masked_upper_median(jnp.asarray(vals), jnp.asarray(keep)))
        want = np.quantile(vals[keep], 0.25) if keep.any() else 0.0
        np.testing.assert_allclose(float(pg._masked_quantile(rn, kp, 0.25)), want, rtol=1e-14)


def test_robust_solve_and_fused_match_jax(rng):
    """Two-pass welsch on the two-lap square with 25% injected outliers
    (``tests/test_robustness.py``): the port's host driver equals JAX's,
    and the port's fused driver equals its host driver."""
    from icp_tpu import robustness as jrob

    perimeter = 32
    twists = np.zeros((2 * perimeter, 3))
    twists[:, 0] = 1.0
    twists[7::8, 2] = np.pi / 2
    gt, meas, poses = _chain(twists, twists + rng.normal(0, 0.03, twists.shape), 2)
    pairs = [[k, k + perimeter] for k in range(0, perimeter + 1, 3)]
    edges, loop_meas = _loops(gt, pairs)
    clean = jpg.graph_from_trajectory(poses, meas, loop_edges=edges,
                                      loop_measurements=loop_meas, loop_weight=10.0)
    jbad, _, jrob_mask = jrob.inject_outliers(clean, 0.25, mode="random", seed=3)
    bad, rob = _port(jbad), _mask(jrob_mask)
    opt, costs, scale, w = pg.robust_solve(bad, robust_edges=rob, iterations=20)
    jopt, jcosts, jscale, jw = jpg.robust_solve(jbad, robust_edges=jrob_mask, iterations=20)
    np.testing.assert_allclose(scale, jscale, rtol=1e-9)
    _assert_poses(opt, jopt, 1e-8)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-8)
    fopt, _, fscale, fw = pg.robust_solve_fused(bad, rob, iterations=20)
    np.testing.assert_allclose(float(fscale), scale, rtol=1e-12)
    np.testing.assert_allclose(fopt.poses.translation.numpy(), opt.poses.translation.numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(fw.numpy(), w.numpy(), atol=1e-12)


def test_explicit_scale_and_pass_counts(rng):
    jgraph, jmask = _square(rng)
    graph, mask = _port(jgraph), _mask(jmask)
    a = pg.robust_solve(graph, robust_edges=mask, robust_scale=0.4, scale_passes=1,
                        iterations=10)
    b = pg.robust_solve_fused(graph, mask, robust_scale=0.4, scale_passes=1, iterations=10)
    assert a[2] == 0.4 and float(b[2]) == 0.4
    np.testing.assert_allclose(a[0].poses.translation.numpy(),
                               b[0].poses.translation.numpy(), atol=1e-12)
    with pytest.raises(ValueError, match="robust_scale"):
        pg.robust_solve(graph, robust_scale="median")
    with pytest.raises(ValueError, match="rule"):
        pg.auto_robust_scale(graph, rule="p95")
    with pytest.raises(ValueError, match="unknown robust kernel"):
        pg.optimize(graph, robust="tukey")
    with pytest.raises(ValueError, match="unknown solver"):
        pg.optimize(graph, solver="qr")
    with pytest.raises(ValueError, match="gnc_gm"):
        pg.optimize(graph, robust="gnc_gm", robust_scale=1.0, early_exit_tol=1e-6)


def _count_steps(monkeypatch):
    """Count ``_geometric_rn2`` evaluations on both sides: with a robust
    kernel the early-exit loop makes one per step (the monotone guard) and
    two for the cost trace.  JAX's loop is a ``while_loop``, so its count
    comes from a ``jax.debug.callback``."""
    counts = {"jax": 0, "port": 0}
    jorig, porig = jpg._geometric_rn2, pg._geometric_rn2

    def jax_counted(graph, poses):
        out = jorig(graph, poses)
        jax.debug.callback(lambda: counts.__setitem__("jax", counts["jax"] + 1))
        return out

    def port_counted(graph, poses):
        counts["port"] += 1
        return porig(graph, poses)

    monkeypatch.setattr(jpg, "_geometric_rn2", jax_counted)
    monkeypatch.setattr(pg, "_geometric_rn2", port_counted)
    return counts


def _far_start_graph(weight):
    """A 5-node SE(2) chain started 2.5 rad off in heading per step, with
    one inconsistent closure (3.6 m off): from there, GN steps of the robust
    solve overshoot and the monotone guard rejects them by a wide margin
    (the cost rises by ~30%), not at roundoff."""
    rng = np.random.default_rng(1)
    n = 5
    twists = np.column_stack([rng.uniform(2.5, 5, n - 1), rng.uniform(-1, 1, n - 1),
                              rng.uniform(-0.5, 0.5, n - 1)])
    init = twists + np.column_stack([np.zeros((n - 1, 2)), rng.uniform(-2.5, 2.5, n - 1)])
    gt, _, _ = _chain(twists, twists, 2)
    _, _, poses = _chain(init, init, 2)
    edges, loop_meas = _loops(gt, [[0, n - 1]], offsets=[[3.0, -2.0]])
    graph = jpg.graph_from_trajectory(poses, jlie.se2_exp(jnp.asarray(twists)),
                                      loop_edges=edges, loop_measurements=loop_meas)
    graph = dataclasses.replace(graph, weights=graph.weights * weight)
    return graph, jnp.arange(graph.num_edges) >= n - 1


def test_early_exit_departs_from_jax_at_the_damping_clamp(monkeypatch):
    """The port departs from the reference here, on purpose.

    JAX's ``early_exit_tol`` loop infers a rejected step from the damping
    ramp (``rejected = new_lm > lm``, ``icp_tpu/pose_graph.py:731``).  Once
    the damping sits at its 1e3 clamp a rejection leaves it unchanged, the
    next step sees zero improvement, and the loop stops as if converged.
    The port tracks the guard's acceptance explicitly, so a rejected step
    never stops it.

    Here (weights 1e6, so the clamp is far below the Hessian's scale): two
    accepted steps at damping 200, a rejection that ramps it to the clamp
    (detected by both), a second rejection at the clamp.  JAX stops after
    that step, four steps in; the port runs its whole budget.  At the clamp
    the rejected step repeats exactly (same poses, same damping), so both
    return the same poses: what the departure changes is the stop, not the
    answer, on a deterministic solve."""
    jgraph, jmask = _far_start_graph(1e6)
    counts = _count_steps(monkeypatch)
    kw = dict(iterations=25, solver="dense", robust="welsch", robust_scale=2.0, damping=200.0,
              early_exit_tol=1e-9)
    want, wc = jpg.optimize(jgraph, robust_edges=jmask, **kw)
    jax.effects_barrier()
    got, gc = pg.optimize(_port(jgraph), robust_edges=_mask(jmask), **kw)
    assert counts["jax"] - 2 == 4
    assert counts["port"] - 2 == 25
    _assert_poses(got, want, 1e-9)
    _assert_trace(gc, wc, 1e-12)
    assert float(gc[-1]) < float(gc[0])


@pytest.mark.parametrize("case", ["far start, weight 1", "square, welsch", "square, huber"])
def test_early_exit_matches_jax_below_the_clamp(rng, monkeypatch, case):
    """Wherever the damping stays below its clamp, rejection by the damping
    ramp and explicit acceptance are the same signal: the two loops take
    the same steps and stop at the same one."""
    if case.startswith("far"):
        jgraph, jmask = _far_start_graph(1.0)
        kw = dict(robust="welsch", robust_scale=2.0)
    else:
        jgraph, jmask = _square(rng)
        kw = dict(robust=case.split(", ")[1], robust_scale=0.3)
    counts = _count_steps(monkeypatch)
    kw.update(iterations=25, solver="dense", early_exit_tol=1e-6)
    want, wc = jpg.optimize(jgraph, robust_edges=jmask, **kw)
    jax.effects_barrier()
    got, gc = pg.optimize(_port(jgraph), robust_edges=_mask(jmask), **kw)
    assert counts["port"] == counts["jax"] < 25 + 2
    assert gc.shape == (2,)
    _assert_poses(got, want, 1e-8)
    _assert_trace(gc, wc, 1e-8)


def test_find_loop_candidates_match_jax(rng):
    n = 40
    # Row-major ties: a 5 x 8 grid of unit spacing, many equal distances.
    grid = np.stack(np.meshgrid(np.arange(8.0), np.arange(5.0)), -1).reshape(-1, 2)
    for t in (rng.uniform(-3, 3, (n, 2)), grid, rng.uniform(-2, 2, (n, 3))):
        d = t.shape[1]
        jposes = jgeo.RigidTransform(jnp.broadcast_to(jnp.eye(d), (n, d, d)), jnp.asarray(t))
        poses = convert.transform_from_numpy(np.broadcast_to(np.eye(d), (n, d, d)), t,
                                             device="cpu")
        exclude = rng.uniform(size=(n, n)) < 0.3
        for kw in (dict(), dict(max_candidates=5), dict(exclude=exclude)):
            jkw = dict(kw, exclude=jnp.asarray(exclude)) if "exclude" in kw else kw
            pkw = dict(kw, exclude=torch.tensor(exclude)) if "exclude" in kw else kw
            got = pg.find_loop_candidates(poses, 2.0, min_separation=5, **pkw)
            want = np.asarray(jpg.find_loop_candidates(jposes, 2.0, min_separation=5, **jkw))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
        pairs, valid = pg.find_loop_candidates_topk(poses, 1.5, min_separation=3, k=64)
        jpairs, jvalid = jpg.find_loop_candidates_topk(jposes, 1.5, min_separation=3, k=64)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(pairs.numpy()[valid.numpy()],
                                      np.asarray(jpairs)[np.asarray(jvalid)])
        assert int(pg._count_loop_candidates(poses, 1.5, 3)) == int(
            jpg._count_loop_candidates(jposes, 1.5, 3))
    assert pg.find_loop_candidates(poses, 1e-9).shape == (0, 2)


def test_pad_edges_and_graph_assembly_match_jax(rng):
    jgraph = _random_graph(rng, t_steps=9, n_loops=2, info=True)
    padded = pg.pad_edges(_port(jgraph), 8)
    jpadded = jpg.pad_edges(jgraph, 8)
    assert padded.num_edges % 8 == 0 and pg.pad_edges(padded, 8) is padded
    for key, value in convert.pose_graph_to_numpy(padded).items():
        want = dataclasses.asdict(jpadded)[key]
        if isinstance(value, dict):
            for k in value:
                np.testing.assert_array_equal(value[k], np.asarray(want[k]))
        else:
            np.testing.assert_array_equal(value, np.asarray(want))
    a, ca = pg.optimize(_port(jgraph), iterations=5, solver="pcg")
    b, cb = pg.optimize(padded, iterations=5, solver="pcg")
    np.testing.assert_allclose(a.poses.translation.numpy(), b.poses.translation.numpy(),
                               atol=1e-12)
    # graph_from_trajectory with per-closure information and per-edge weights.
    poses = jgraph.poses
    m = rng.normal(size=(3, 3, 3))
    info = np.einsum("eij,ekj->eik", m, m)
    odo = jgeo.RigidTransform(jgraph.measurements.rotation[:8],
                              jgraph.measurements.translation[:8])
    loops = jgeo.RigidTransform(jgraph.measurements.rotation[5:8],
                                jgraph.measurements.translation[5:8])
    edges = np.array([[0, 4], [2, 8], [1, 6]], dtype=np.int32)
    odo_w = rng.uniform(0.5, 2.0, 8)
    want = jpg.graph_from_trajectory(poses, odo, jnp.asarray(edges), loops,
                                     odometry_weight=jnp.asarray(odo_w), loop_weight=7.0,
                                     loop_information=jnp.asarray(info))
    tp = convert.transform_from_numpy(np.asarray(poses.rotation), np.asarray(poses.translation),
                                      device="cpu")
    got = pg.graph_from_trajectory(
        tp, convert.transform_from_numpy(np.asarray(odo.rotation), np.asarray(odo.translation),
                                         device="cpu"),
        torch.tensor(edges), convert.transform_from_numpy(
            np.asarray(loops.rotation), np.asarray(loops.translation), device="cpu"),
        odometry_weight=torch.tensor(odo_w), loop_weight=7.0,
        loop_information=torch.tensor(info))
    np.testing.assert_array_equal(got.edges_ij.numpy(), np.asarray(want.edges_ij))
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))
    np.testing.assert_allclose(got.sqrt_information.numpy(), np.asarray(want.sqrt_information),
                               atol=1e-12)
    bare = pg.graph_from_trajectory(tp, got.measurements)
    assert bare.num_edges == 8 and bare.sqrt_information is None


def test_project_rotation_matches_jax(rng):
    for d in (2, 3):
        m = rng.normal(size=(6, d, d))
        got = geometry.project_rotation(torch.tensor(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(jgeo.project_rotation(jnp.asarray(m))),
                                   atol=1e-12)
        np.testing.assert_allclose(np.linalg.det(got.numpy()), 1.0, atol=1e-12)
        tf = geometry.renormalize(convert.transform_from_numpy(m, m[..., 0], device="cpu"))
        assert torch.equal(tf.rotation, got) and np.array_equal(tf.translation.numpy(),
                                                                 m[..., 0])


def _circle(rng):
    """``tests/test_odometry_posegraph.py::test_slam_pipeline_end_to_end``:
    25 scans of one world around a circle; numpy clouds."""
    world = rng.uniform(-30, 30, (128, 2))
    scans = []
    for k in range(25):
        phi = 2 * math.pi * k / 24
        px, py, pth = 4.0 * math.cos(phi), 4.0 * math.sin(phi), phi + math.pi / 2
        c, s = np.cos(pth), np.sin(pth)
        pts = (world - [px, py]) @ np.array([[c, -s], [s, c]])
        scans.append(pts + rng.normal(0, 0.02, pts.shape))
    return np.stack(scans)


def test_register_loop_closures_match_jax(rng):
    """On the port's odometry chain (the chain itself is held against JAX in
    test_torch_odometry.py): candidates exact, then the closure batch from
    the poses' seeds under ``max_cost`` (six of the seven converge in the
    wrong basin, cost > 3), and from the coarse initializer."""
    pts = _circle(rng)
    counts = np.full(len(pts), pts.shape[1], dtype=np.int32)
    cfg = dict(max_iterations=50, angle_tolerance=1e-5, translation_tolerance=1e-5)
    jstack = J.cloud.PointCloud(jnp.asarray(pts), jnp.asarray(counts))
    stack = convert.cloud_from_numpy(pts, counts, device="cpu")
    jmethod = J.from_method("trimmed", 2, J.Config(overlap_rate=1.0))
    method = T.from_method("trimmed", 2, T.Config(overlap_rate=1.0))
    traj = T.odometry.chain_scans(stack, method, T.DriverConfig(**cfg))
    jposes = jgeo.RigidTransform(*(jnp.asarray(x) for x in convert.transform_to_numpy(
        traj.poses)))
    cands = pg.find_loop_candidates(traj.poses, radius=2.5, min_separation=18)
    jcands = jpg.find_loop_candidates(jposes, radius=2.5, min_separation=18)
    np.testing.assert_array_equal(cands.numpy(), np.asarray(jcands))
    assert [0, 24] in cands.tolist() and len(cands) > 2
    kept = {}
    for name, kw in (("max_cost", dict(max_cost=1.0)), ("coarse", dict(coarse=True))):
        edges, meas, costs = pg.register_loop_closures(stack, traj.poses, cands, method,
                                                       T.DriverConfig(**cfg), **kw)
        jedges, jmeas, jcosts = jpg.register_loop_closures(
            jstack, jposes, jcands, jmethod, J.DriverConfig(**cfg), **kw)
        np.testing.assert_array_equal(edges.numpy(), np.asarray(jedges))
        np.testing.assert_allclose(meas.translation.numpy(), np.asarray(jmeas.translation),
                                   atol=1e-9)
        np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), atol=1e-9)
        kept[name] = len(edges)
    assert kept == {"max_cost": 1, "coarse": len(cands)}
    edges, meas, _ = pg.register_loop_closures(stack, traj.poses, cands, method,
                                               T.DriverConfig(**cfg), max_cost=1.0)
    graph = pg.graph_from_trajectory(traj.poses, geometry.inverse(traj.relative),
                                     loop_edges=edges, loop_measurements=meas, loop_weight=10.0)
    opt, gcost = pg.optimize(graph, iterations=10)
    end = float(np.linalg.norm(opt.poses.translation[-1].numpy()))
    assert end < 0.2 * float(np.linalg.norm(traj.poses.translation[-1].numpy()))
    empty = pg.register_loop_closures(stack, traj.poses, np.zeros((0, 2)), method,
                                      T.DriverConfig(**cfg))
    assert empty[0].shape == (0, 2) and empty[1].translation.shape == (0, 2)


def test_pose_graph_convert_round_trip(rng):
    jgraph = _random_graph(rng, t_steps=6, n_loops=2, dim=3, info=True)
    graph = _port(jgraph)
    assert (graph.num_nodes, graph.num_edges, graph.dim) == (6, 7, 3)
    back = convert.pose_graph_to_numpy(graph)
    again = convert.pose_graph_from_numpy(back, device="cpu")
    assert torch.equal(again.sqrt_information, graph.sqrt_information)
    assert again.edges_ij.dtype == torch.int32
    scalar = convert.pose_graph_from_numpy(dict(back, sqrt_information=None), device="cpu",
                                           dtype=torch.float32)
    assert scalar.sqrt_information is None and scalar.poses.dtype == torch.float32


@pytest.mark.cuda
def test_read_and_optimize_default_to_the_card(cuda_device):
    graph = T.io.read_g2o(M600)
    assert graph.poses.translation.device.type == "cuda"
    assert graph.poses.dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dense", "cg", "pcg"])
def test_optimize_on_card_agrees_with_cpu(rng, cuda_device, solver):
    """The square scenario, gnc_gm: CUDA float32 poses within 2e-3 m of the
    CPU float64 solve."""
    jgraph, jmask = _square(rng)
    kw = dict(iterations=30, solver=solver, robust="gnc_gm")
    cpu, _ = pg.optimize(_port(jgraph), robust_edges=_mask(jmask), **kw)
    card, costs = pg.optimize(_port(jgraph, device=cuda_device),
                              robust_edges=_mask(jmask, cuda_device), **kw)
    assert torch.isfinite(costs).all()
    dt = np.abs(card.poses.translation.double().cpu().numpy() - cpu.poses.translation.numpy())
    assert dt.max() <= 2e-3


@pytest.mark.cuda
def test_m600_pcg_on_card_agrees_with_cpu(cuda_device):
    kw = dict(iterations=30, solver="pcg", cg_iterations=50)
    cpu, ccost = pg.optimize(T.io.read_g2o(M600, device="cpu"), **kw)
    card, gcost = pg.optimize(T.io.read_g2o(M600, device=cuda_device), **kw)
    assert float(gcost[-1]) < 3 * 3 * 1210
    dt = np.abs(card.poses.translation.double().cpu().numpy() - cpu.poses.translation.numpy())
    assert dt.max() <= 2e-3


@pytest.mark.cuda
def test_loop_closures_on_card_agree_with_cpu(rng, cuda_device):
    pts = _circle(rng)
    counts = np.full(len(pts), pts.shape[1], dtype=np.int32)
    cfg = T.DriverConfig(max_iterations=50, angle_tolerance=1e-5, translation_tolerance=1e-5)
    method = T.from_method("trimmed", 2, T.Config(overlap_rate=1.0))
    out = {}
    for dev in ("cpu", cuda_device):
        stack = convert.cloud_from_numpy(pts, counts, device=dev)
        traj = T.odometry.chain_scans(stack, method, cfg)
        cands = pg.find_loop_candidates(traj.poses, radius=1.5, min_separation=20)
        edges, meas, _ = pg.register_loop_closures(stack, traj.poses, cands, method, cfg)
        out[str(dev)] = (edges.cpu().numpy(), meas.translation.double().cpu().numpy())
    (e_cpu, m_cpu), (e_card, m_card) = out.values()
    np.testing.assert_array_equal(e_card, e_cpu)
    assert np.abs(m_card - m_cpu).max() <= 2e-3
