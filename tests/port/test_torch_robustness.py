"""``icp_tpu_torch.robustness`` against the JAX package, float64 on the CPU:
``inject_outliers`` bit-equal (random and clustered, SE(2) and SE(3) with
information blocks, rate 0 and the errors), ``closure_mask`` and
``classify_closures`` equal, and one ``run_protocol`` cell (random, rate 0.2,
L2 and welsch, two passes) equal to JAX's records: the classification
exactly, the scale, ATE and chi² to 1e-8 relative."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu import geometry as jgeo
from icp_tpu import lie as jlie
from icp_tpu import pose_graph as jpg
from icp_tpu import robustness as jrob
from icp_tpu.ops import covariance as jcov
from icp_tpu_torch import convert, robustness


def _port(jgraph):
    return convert.pose_graph_from_numpy(dataclasses.asdict(jgraph), device="cpu")


def _lap_graph(rng, dim=2, laps=2, side=6, info=False):
    """``laps`` laps of a square (2D) or a rising square helix (3D) with
    closures every third step between laps, noisy odometry (JAX)."""
    d = jlie.dof(dim)
    perimeter = 4 * side
    twists = np.zeros((laps * perimeter, d))
    twists[:, 0] = 1.0
    twists[side - 1::side, d - 1] = np.pi / 2
    if dim == 3:
        twists[:, 2] = 0.05
    gt = [jgeo.identity(dim, dtype=jnp.float64)]
    for k in range(len(twists)):
        gt.append(jgeo.compose(gt[-1], jlie.exp(jnp.asarray(twists[k]), dim)))
    meas = jlie.exp(jnp.asarray(twists + rng.normal(0, 0.03, twists.shape)), dim)
    init = [gt[0]]
    for k in range(len(twists)):
        init.append(jgeo.compose(init[-1], jgeo.RigidTransform(meas.rotation[k],
                                                               meas.translation[k])))
    poses = jgeo.RigidTransform(jnp.stack([p.rotation for p in init]),
                                jnp.stack([p.translation for p in init]))
    pairs = [(k, k + perimeter) for k in range(0, (laps - 1) * perimeter + 1, 3)]
    rels = [jgeo.compose(jgeo.inverse(gt[a]), gt[b]) for a, b in pairs]
    graph = jpg.graph_from_trajectory(
        poses, meas, loop_edges=jnp.asarray(pairs, dtype=jnp.int32),
        loop_measurements=jgeo.RigidTransform(jnp.stack([r.rotation for r in rels]),
                                              jnp.stack([r.translation for r in rels])),
        loop_weight=10.0)
    if info:
        m = rng.normal(size=(graph.num_edges, d, d))
        graph = dataclasses.replace(graph, sqrt_information=jcov.sqrt_information(
            jnp.asarray(np.einsum("eij,ekj->eik", m, m) + d * np.eye(d))))
    return graph


@pytest.mark.parametrize("dim, info", [(2, False), (3, True)], ids=["se2", "se3-info"])
@pytest.mark.parametrize("mode", ["random", "clustered"])
def test_inject_outliers_bit_equal_to_jax(rng, dim, info, mode):
    jgraph = _lap_graph(rng, dim=dim, laps=3, info=info)
    graph = _port(jgraph)
    kw = dict(mode=mode, seed=7, min_separation=10, cluster_size=4)
    bad, is_out, rob = robustness.inject_outliers(graph, 0.3, **kw)
    jbad, jis_out, jrob_mask = jrob.inject_outliers(jgraph, 0.3, **kw)
    want = dataclasses.asdict(jbad)
    for key, value in convert.pose_graph_to_numpy(bad).items():
        if isinstance(value, dict):
            for k in value:
                np.testing.assert_array_equal(value[k], np.asarray(want[key][k]), err_msg=key)
        else:
            np.testing.assert_array_equal(value, np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(is_out.numpy(), np.asarray(jis_out))
    np.testing.assert_array_equal(rob.numpy(), np.asarray(jrob_mask))
    n_true = int(robustness.closure_mask(graph).sum())
    assert int(is_out.sum()) == round(0.3 / 0.7 * n_true)


def test_closure_mask_zero_rate_and_errors(rng):
    jgraph = _lap_graph(rng)
    graph = _port(jgraph)
    for sep in (2, 5):
        np.testing.assert_array_equal(robustness.closure_mask(graph, sep).numpy(),
                                      np.asarray(jrob.closure_mask(jgraph, sep)))
    same, is_out, rob = robustness.inject_outliers(graph, 0.0)
    assert same is graph and not bool(is_out.any())
    np.testing.assert_array_equal(rob.numpy(), robustness.closure_mask(graph).numpy())
    with pytest.raises(ValueError, match="rate"):
        robustness.inject_outliers(graph, 1.0)
    with pytest.raises(ValueError, match="mode"):
        robustness.inject_outliers(graph, 0.2, mode="adversarial")


def test_classify_closures_matches_jax(rng):
    for _ in range(3):
        w = rng.uniform(0, 1, 40)
        out = rng.uniform(size=40) < 0.3
        rob = out | (rng.uniform(size=40) < 0.5)
        got = robustness.classify_closures(torch.tensor(w), torch.tensor(out), torch.tensor(rob))
        assert got == jrob.classify_closures(w, out, rob)
    clean = robustness.classify_closures(np.ones(5), np.zeros(5, bool), np.zeros(5, bool))
    assert clean["precision"] == clean["recall"] == clean["inliers_kept"] == 1.0


def test_run_protocol_cell_matches_jax(rng):
    """One cell of the Vertigo protocol on a small two-lap graph."""
    jgraph = _lap_graph(rng)
    kw = dict(rates=(0.2,), modes=("random",), kernels=("none", "welsch"), iterations=15,
              solver="dense", seed=3, min_separation=10, scale_passes=2)
    got = robustness.run_protocol(_port(jgraph), **kw)
    want = jrob.run_protocol(jgraph, **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key, value in w.items():
            if isinstance(value, float) and key not in ("precision", "recall", "inliers_kept"):
                np.testing.assert_allclose(g[key], value, rtol=1e-8, atol=1e-12, err_msg=key)
            else:
                assert g[key] == value, key
    assert got[1]["recall"] == 1.0 and got[1]["inliers_kept"] == 1.0
