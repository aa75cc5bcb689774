"""The stepped driver and ``make_converge_fn``: ``converge_stepped`` runs
:func:`converge`'s loop (equal results lane by lane, as the JAX package's
stepped driver equals its compiled one) and adds the host-side time limit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T
from icp_tpu_torch import convert

BENCH = dict(max_iterations=50, angle_tolerance=0.1 * np.pi / 180, translation_tolerance=0.01)


def _inputs(scan_dir, batch=4, seed=3):
    a = T.io.parse_lidar_scan_array(f"{scan_dir}/scan2/first.csv")
    b = T.io.parse_lidar_scan_array(f"{scan_dir}/scan2/second.csv")
    rng = np.random.default_rng(seed)
    guess = T.from_angle_2d(torch.tensor(rng.uniform(-0.05, 0.05, batch)),
                            torch.tensor(rng.uniform(-0.2, 0.2, (batch, 2))))
    return (T.stack([T.from_points(a, device="cpu")] * batch),
            T.stack([T.from_points(b, device="cpu")] * batch), guess)


def _assert_same(got, want):
    assert torch.equal(got.iteration_count, want.iteration_count)
    assert torch.equal(got.cost, want.cost)
    assert torch.equal(got.transform.rotation, want.transform.rotation)
    assert torch.equal(got.transform.translation, want.transform.translation)


@pytest.mark.parametrize("name", ["trimmed", "vanilla", "feature_aware"])
def test_stepped_equals_converge(scan_dir, name):
    src, tgt, guess = _inputs(scan_dir)
    method, cfg = T.from_method(name, 2), T.DriverConfig(**BENCH)
    want, _ = T.converge(method, src, tgt, guess, cfg)
    got, _ = T.converge_stepped(method, src, tgt, guess, cfg)
    _assert_same(got, want)
    timed, _ = T.converge_stepped(method, src, tgt, guess,
                                  dataclasses.replace(cfg, time_limit=3600.0))
    _assert_same(timed, want)
    if name == "trimmed":
        assert len(set(want.iteration_count.tolist())) > 1  # lanes froze at different times


def test_stepped_matches_jax_stepped(scan_dir):
    """The same lanes through the JAX package's ``converge_stepped``."""
    src, tgt, guess = _inputs(scan_dir, batch=2, seed=8)
    jcfg = J.DriverConfig(**BENCH)
    jsrc, jtgt = (J.PointCloud(*(x.numpy() for x in (c.points, c.count))) for c in (src, tgt))
    jguess = J.RigidTransform(guess.rotation.numpy(), guess.translation.numpy())
    want, _ = J.converge_stepped(J.from_method("trimmed", 2), jsrc, jtgt, jguess, jcfg)
    got, _ = T.converge_stepped(T.from_method("trimmed", 2), src, tgt, guess,
                                convert.driver_config_from_fields(dataclasses.asdict(jcfg)))
    np.testing.assert_array_equal(got.iteration_count.numpy(), np.asarray(want.iteration_count))
    np.testing.assert_allclose(got.transform.translation.numpy(),
                               np.asarray(want.transform.translation), atol=1e-9)


def test_time_limit_zero_runs_no_iteration(scan_dir):
    src, tgt, guess = _inputs(scan_dir, batch=2)
    cfg = T.DriverConfig(time_limit=0.0, **BENCH)
    result, state = T.converge_stepped(T.from_method("trimmed", 2), src, tgt, guess, cfg)
    assert not result.iteration_count.any()
    assert torch.equal(result.transform.translation, guess.translation)
    assert torch.equal(state.transform.rotation, guess.rotation)


def test_stepped_checks_its_inputs(scan_dir):
    src, tgt, guess = _inputs(scan_dir, batch=1)
    method = T.from_method("trimmed", 2)
    with pytest.raises(ValueError, match="dimension mismatch"):
        T.converge_stepped(method, src, tgt, T.identity(3, (1,), device="cpu"),
                           T.DriverConfig(max_iterations=1))
    with pytest.raises(ValueError, match="no termination criterion"):
        T.converge_stepped(method, src, tgt, guess, T.DriverConfig(min_iterations=1))
    with pytest.raises(ValueError, match="converge_stepped"):
        T.converge(method, src, tgt, guess, T.DriverConfig(time_limit=1.0))


def test_make_converge_fn_gives_converge(scan_dir):
    src, tgt, guess = _inputs(scan_dir)
    method, cfg = T.from_method("feature_aware", 2), T.DriverConfig(**BENCH)
    fn = T.make_converge_fn(method, cfg)
    got, state = fn(src, tgt, guess)
    want, _ = T.converge(method, src, tgt, guess, cfg)
    _assert_same(got, want)
    assert state.source is src
