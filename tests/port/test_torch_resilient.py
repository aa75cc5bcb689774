"""``icp_tpu_torch.resilient`` and ``icp_tpu_torch.checkpoint`` against the
JAX package, float64 on the CPU:

* ``.npz`` checkpoints cross over both ways with equal leaves (dicts,
  transforms, pose graphs), and ``load_pytree`` / ``load_pose_graph``;
* ``CheckpointManager``: rotation, no temporary file left behind, the
  corrupt-newest fallback, and files written by the JAX package;
* ``resumable_stream_odometry``: the trajectory within 1e-8 m of JAX's, a
  killed run resumed bit for bit, and a run killed in the JAX package
  resumed in the port within 1e-8 m; ``run_with_retries`` through
  preemptions and out of budget; ``job_status`` / ``format_status`` the
  same strings as JAX's;
* ``resumable_online_slam``: a JAX checkpoint continues in the port within
  1e-8 m of JAX's uninterrupted run, and the port's own kill and resume
  is bit-identical to its uninterrupted run.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T
from icp_tpu import checkpoint as jckpt
from icp_tpu import resilient as jres
from icp_tpu_torch import checkpoint, convert, resilient

TOL = 1e-8


def _scans(seed=123, t_total=12, n=64):
    """``tests/test_resilient.py::_scan_sequence``: (jax clouds, port clouds)."""
    rng = np.random.default_rng(seed)
    world = rng.uniform(-12, 12, (n, 2))
    js, ts = [], []
    for t in range(t_total):
        ang = 0.04 * t
        c, s = np.cos(ang), np.sin(ang)
        pts = (world - [0.12 * t, 0.0]) @ np.array([[c, -s], [s, c]])
        js.append(J.from_points(pts, capacity=n, dtype=np.float64))
        ts.append(T.from_points(pts, capacity=n, dtype=torch.float64, device="cpu"))
    return js, ts


_ARGS = {}


def _odometry_args(mod):
    """One method object per package for the module (the JAX package caches
    its compiled programs per method object)."""
    if mod not in _ARGS:
        _ARGS[mod] = (mod.from_method("robust", 2), mod.DriverConfig(
            max_iterations=60, angle_tolerance=1e-6, translation_tolerance=1e-6))
    return _ARGS[mod]


@pytest.fixture(scope="module")
def sequence():
    return _scans()


# -- checkpoint ----------------------------------------------------------------


def _graph(rng):
    t = 5
    poses = J.geometry.RigidTransform(
        jnp.asarray(np.stack([np.eye(2)] * t)), jnp.asarray(rng.normal(size=(t, 2))))
    meas = J.geometry.RigidTransform(
        jnp.asarray(np.stack([np.eye(2)] * (t - 1))), jnp.asarray(rng.normal(size=(t - 1, 2))))
    return J.pose_graph.graph_from_trajectory(poses, meas)


def test_port_file_loads_in_jax(rng, tmp_path):
    rot, trans = rng.normal(size=(4, 2, 2)), rng.normal(size=(4, 2))
    tree = {"translation": torch.as_tensor(trans), "rotation": torch.as_tensor(rot),
            "extra": [torch.arange(3), (torch.ones(2), None)]}
    path = str(tmp_path / "port.npz")
    checkpoint.save_pytree(path, tree)
    jtree = {"translation": jnp.asarray(trans), "rotation": jnp.asarray(rot),
             "extra": [jnp.arange(3), (jnp.ones(2), None)]}
    jckpt.save_pytree(str(tmp_path / "jax.npz"), jtree)
    got, ref = jckpt.load_leaves(path), jckpt.load_leaves(str(tmp_path / "jax.npz"))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    # Back into the structure, on the device of the tensors it replaces.
    back = checkpoint.load_pytree(path, tree)
    assert torch.equal(back["rotation"], tree["rotation"]) and back["extra"][1][1] is None
    loaded = jckpt.load_pytree(path, jtree)
    np.testing.assert_array_equal(np.asarray(loaded["translation"]), trans)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_pytree(path, {"rotation": tree["rotation"]})


def test_jax_file_loads_in_port(rng, tmp_path):
    jt = J.geometry.RigidTransform(jnp.asarray(rng.normal(size=(3, 3, 3))),
                                   jnp.asarray(rng.normal(size=(3, 3))))
    path = str(tmp_path / "jax.npz")
    jckpt.save_pytree(path, jt)
    like = T.RigidTransform(torch.zeros(3, 3, 3, dtype=torch.float64),
                            torch.zeros(3, 3, dtype=torch.float64))
    got = checkpoint.load_pytree(path, like)
    np.testing.assert_array_equal(got.rotation.numpy(), np.asarray(jt.rotation))
    np.testing.assert_array_equal(got.translation.numpy(), np.asarray(jt.translation))
    for g, r in zip(checkpoint.load_leaves(path), jckpt.load_leaves(path)):
        np.testing.assert_array_equal(g, r)


def test_pose_graph_round_trips(rng, tmp_path):
    jg = _graph(rng)
    tg = convert.pose_graph_from_numpy(dataclasses.asdict(jg), device="cpu")
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_pose_graph(jpath, jg)
    checkpoint.save_pose_graph(tpath, tg)
    for g, r in zip(jckpt.load_leaves(tpath), jckpt.load_leaves(jpath)):
        np.testing.assert_array_equal(g, r)
    for path in (jpath, tpath):
        got = checkpoint.load_pose_graph(path, device="cpu")
        assert got.edges_ij.dtype == torch.int32 and got.sqrt_information is None
        want = convert.pose_graph_to_numpy(tg)
        np.testing.assert_array_equal(convert.pose_graph_to_numpy(got)["poses"]["translation"],
                                      want["poses"]["translation"])
        np.testing.assert_array_equal(got.edges_ij.numpy(), want["edges_ij"])
        np.testing.assert_array_equal(got.weights.numpy(), want["weights"])
    jback = jckpt.load_pose_graph(tpath)
    np.testing.assert_array_equal(np.asarray(jback.measurements.translation),
                                  np.asarray(jg.measurements.translation))


# -- CheckpointManager ------------------------------------------------------------


def test_manager_rotation_and_atomicity(tmp_path):
    mgr = resilient.CheckpointManager(str(tmp_path), keep=2)
    for step in (0, 5, 9):
        mgr.save(step, {"x": torch.full((3,), step)})
    assert sorted(os.listdir(tmp_path)) == ["ckpt_000000005.npz", "ckpt_000000009.npz"]
    step, arrays = mgr.latest()
    assert step == 9 and arrays["x"][0] == 9
    # The JAX package's manager reads the same directory.
    jstep, jarrays = jres.CheckpointManager(str(tmp_path)).latest()
    assert jstep == 9 and (jarrays["x"] == arrays["x"]).all()


def test_corrupt_latest_falls_back(tmp_path):
    jres.CheckpointManager(str(tmp_path)).save(1, {"x": np.asarray([1.0])})
    mgr = resilient.CheckpointManager(str(tmp_path), keep=3)
    mgr.save(2, {"x": np.asarray([2.0])})
    with open(tmp_path / "ckpt_000000002.npz", "wb") as f:
        f.write(b"garbage")
    with pytest.warns(UserWarning, match="unreadable"):
        step, arrays = mgr.latest()
    assert step == 1 and arrays["x"][0] == 1.0
    assert resilient.CheckpointManager(str(tmp_path / "empty")).latest() is None


# -- resumable stream odometry ---------------------------------------------------


def _port_stream(scans, directory, every=4):
    return list(resilient.resumable_stream_odometry(
        scans, *_odometry_args(T), str(directory), checkpoint_every=every, device="cpu"))


@pytest.fixture(scope="module")
def jax_stream(sequence, tmp_path_factory):
    """JAX's uninterrupted stream, and a JAX run killed after scan 6."""
    jscans, _ = sequence
    full = list(jres.resumable_stream_odometry(
        jscans, *_odometry_args(J), str(tmp_path_factory.mktemp("jfull")), checkpoint_every=4))
    part = tmp_path_factory.mktemp("jpart")
    gen = jres.resumable_stream_odometry(jscans, *_odometry_args(J), str(part),
                                         checkpoint_every=4)
    for item in gen:
        if item[0] == 6:
            gen.close()  # a simulated kill
            break
    return full, part


def _assert_stream(got, want, exact=False):
    for (t, pose, kf, _), (wt, wpose, wkf, _) in zip(got, want):
        assert (t, kf) == (wt, wkf)
        for a, b in ((pose.rotation, wpose.rotation), (pose.translation, wpose.translation)):
            if exact:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            else:
                np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=TOL)


def test_stream_matches_jax(sequence, jax_stream, tmp_path):
    _, tscans = sequence
    got = _port_stream(tscans, tmp_path)
    assert len(got) == len(jax_stream[0]) == 12
    _assert_stream(got, jax_stream[0])


def test_stream_resume_is_bit_identical(sequence, tmp_path):
    _, tscans = sequence
    full = _port_stream(tscans, tmp_path / "full")
    gen = resilient.resumable_stream_odometry(tscans, *_odometry_args(T), str(tmp_path / "part"),
                                              checkpoint_every=4, device="cpu")
    for item in gen:
        if item[0] == 6:
            gen.close()
            break
    assert resilient.job_status(str(tmp_path / "part"))["last_scan"] == 3
    resumed = _port_stream(tscans, tmp_path / "part")
    assert resumed[0][0] == 4 and resumed[-1][0] == 11
    _assert_stream(resumed, full[4:], exact=True)


def test_jax_killed_stream_resumes_in_port(sequence, jax_stream):
    """The JAX run's checkpoints (killed after scan 6, saved at scan 3)
    resume in the port, which finishes within 1e-8 m of JAX's uninterrupted
    run."""
    _, tscans = sequence
    full, part = jax_stream
    status = resilient.format_status(str(part))
    assert status == jres.format_status(str(part))
    assert resilient.job_status(str(part)) == jres.job_status(str(part))
    resumed = _port_stream(tscans, part)
    assert resumed[0][0] == 4
    _assert_stream(resumed, full[4:])
    assert resilient.format_status(str(part)) == jres.format_status(str(part))
    assert resilient.job_status(str(part) + "-none") == {"checkpointed": False}


def test_run_with_retries_through_preemptions(sequence, tmp_path):
    _, tscans = sequence
    crashes, restarts = {"left": 2}, []

    def job():
        out = []
        for item in resilient.resumable_stream_odometry(
                tscans, *_odometry_args(T), str(tmp_path / "sup"), checkpoint_every=3,
                device="cpu"):
            out.append(item)
            if crashes["left"] and item[0] in (4, 8):
                crashes["left"] -= 1
                raise RuntimeError("preempted")
        return out

    final = resilient.run_with_retries(job, max_restarts=5,
                                       on_restart=lambda a, e: restarts.append(str(e)))
    assert restarts == ["preempted", "preempted"] and final[-1][0] == 11
    clean = _port_stream(tscans, tmp_path / "clean")
    np.testing.assert_array_equal(final[-1][1].translation.numpy(),
                                  clean[-1][1].translation.numpy())


def test_run_with_retries_exhausts_budget():
    calls = []

    def job():
        calls.append(1)
        raise ValueError("always fails")

    with pytest.raises(ValueError):
        resilient.run_with_retries(job, max_restarts=2)
    assert len(calls) == 3


def test_stream_needs_a_card_by_default(sequence, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        next(resilient.resumable_stream_odometry(sequence[1], *_odometry_args(T),
                                                 str(tmp_path)))


# -- resumable online SLAM -------------------------------------------------------

SLAM_KW = dict(translation_threshold=0.4, angle_threshold=0.15, loop_every=4, loop_radius=1.5,
               loop_min_separation=10, robust="gnc_gm", robust_scale="auto",
               odometry_weight=100.0, loop_weight=100.0)


def _slam_args(mod, trimmed_pair):
    method = trimmed_pair[0] if mod is J else trimmed_pair[1]
    return method, mod.DriverConfig(max_iterations=50, angle_tolerance=1e-5,
                                    translation_tolerance=1e-5)


def _drain(gen):
    online = None
    for _, online, _ in gen:
        pass
    online.finalize()
    return online


def test_online_slam_jax_checkpoint_resumes_in_port(circle_scans, trimmed_pair, tmp_path):
    """The circle of ``tests/test_online_slam.py`` (its revisit closes the
    loop): JAX's uninterrupted run checkpoints every 5 scans; its checkpoint
    at scan 25 continues in the port, within 1e-8 m of JAX's end state."""
    jscans, tscans = circle_scans
    jmgr = jres.CheckpointManager(str(tmp_path / "jax"), keep=10)
    ref = _drain(jres.resumable_online_slam(jscans, *_slam_args(J, trimmed_pair), jmgr,
                                            checkpoint_every=5, **SLAM_KW))
    for step in (30, 35, 40, 45):
        os.remove(jmgr._path(step))
    resumed = _drain(resilient.resumable_online_slam(
        tscans, *_slam_args(T, trimmed_pair), resilient.CheckpointManager(str(tmp_path / "jax")),
        checkpoint_every=5, device="cpu", **SLAM_KW))
    assert resumed._loop_edges == ref._loop_edges and ref._loop_edges
    np.testing.assert_allclose(resumed.keyframe_poses.translation.numpy(),
                               np.asarray(ref.keyframe_poses.translation), rtol=0, atol=TOL)
    np.testing.assert_allclose(resumed.keyframe_poses.rotation.numpy(),
                               np.asarray(ref.keyframe_poses.rotation), rtol=0, atol=TOL)


def test_online_slam_resume_is_bit_identical(circle_scans, trimmed_pair, tmp_path):
    _, tscans = circle_scans
    args = (tscans, *_slam_args(T, trimmed_pair))
    ref = _drain(resilient.resumable_online_slam(
        *args, resilient.CheckpointManager(str(tmp_path / "ref")), device="cpu", **SLAM_KW))
    mgr = resilient.CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    for t, _, _ in resilient.resumable_online_slam(*args, mgr, checkpoint_every=5,
                                                   device="cpu", **SLAM_KW):
        if t == 31:
            break  # killed after the checkpoint at scan 30
    resumed = _drain(resilient.resumable_online_slam(*args, mgr, checkpoint_every=5,
                                                     device="cpu", **SLAM_KW))
    np.testing.assert_array_equal(resumed.keyframe_poses.translation.numpy(),
                                  ref.keyframe_poses.translation.numpy())
    np.testing.assert_array_equal(resumed.keyframe_poses.rotation.numpy(),
                                  ref.keyframe_poses.rotation.numpy())
    assert resumed._loop_edges == ref._loop_edges
