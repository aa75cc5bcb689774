"""``icp_tpu_torch.slam`` against the JAX package, float64 on the CPU, on the
JAX tests' seeded scenarios (the circle of ``tests/test_online_slam.py``,
49 scans at capacity 152; the distinctive world of
``tests/test_descriptor.py``; the merge of ``tests/test_merge_sessions.py``):

* ``OnlineSlam`` serial (radius detector, single-pass then the two-pass
  mapping-scale solve, an injected wrong closure), pipelined (deferred
  promotion on every other scan), with the descriptor detector, the anomaly
  retry in both modes, a small 3D stream, and ``closure_information`` in
  the merge's refinements: per scan ``is_keyframe``, ``refined`` and
  ``num_closures`` exact and the live pose within 1e-8 m; the closures and
  tried pairs exact,
  ``closure_weights`` within 1e-8, and ``state_dict`` with JAX's keys,
  dtypes and shapes, its values within 1e-8;
* ``_masked_median`` bit-equal to ``np.median`` (odd and even counts);
* a JAX ``state_dict`` taken mid-stream continues in the port within 1e-8 m
  of JAX's uninterrupted run, and the port's own resume (serial and
  pipelined) is bit-identical to its uninterrupted run;
* ``run_slam`` (radius under gnc_gm, descriptor), ``relocalize`` and
  ``OnlineSlam.relocalize``, ``merge_sessions`` with an explicit anchor
  and with a descriptor-recovered one, within 1e-8 m;
* the two departures from the reference, each against the JAX line.

Each JAX run is computed once per module.  The ``cuda``-marked twin streams
the circle on the card (float32) against the CPU float64 run.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T
from icp_tpu import slam as jslam
from icp_tpu_torch import convert, slam

TOL = 1e-8
CIRCLE_KW = dict(translation_threshold=0.4, angle_threshold=0.15, loop_every=4, loop_radius=1.5,
                 loop_min_separation=10, robust="gnc_gm", robust_scale="auto",
                 odometry_weight=100.0, loop_weight=100.0)


def _jcfg():
    return J.DriverConfig(max_iterations=50, angle_tolerance=1e-5, translation_tolerance=1e-5)


def _tcfg():
    return T.DriverConfig(max_iterations=50, angle_tolerance=1e-5, translation_tolerance=1e-5)


_METHODS = {}


@pytest.fixture(scope="module", autouse=True)
def _shared_methods(trimmed_pair):
    _METHODS[2] = trimmed_pair


def _methods(dim=2):
    """One method object per package and dimension (the JAX package caches
    its compiled programs per method object)."""
    if dim not in _METHODS:
        _METHODS[dim] = (J.from_method("trimmed", dim, J.Config(overlap_rate=1.0)),
                         T.from_method("trimmed", dim, T.Config(overlap_rate=1.0)))
    return _METHODS[dim]


def _pair(points, capacity):
    """One scan as a JAX cloud and a port cloud (CPU) from the same array."""
    j = J.from_points(points, capacity=capacity, dtype=np.float64)
    return j, convert.cloud_from_numpy(np.asarray(j.points), np.asarray(j.count), device="cpu")


def _distinctive_scan_2d(rng, n=360):
    """``tests/test_descriptor.py::distinctive_scan_2d``."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    radius = rng.uniform(6.0, 9.0) * np.ones(n)
    for _ in range(4):
        k = rng.integers(1, 9)
        radius += rng.uniform(0.3, 1.8) * np.sin(k * ang + rng.uniform(0, 2 * np.pi))
    for _ in range(3):
        a0 = rng.uniform(0, 2 * np.pi)
        w = rng.uniform(0.2, 0.6)
        gap = ((ang - a0 + np.pi) % (2 * np.pi) - np.pi)
        radius = np.where(np.abs(gap) < w, radius * rng.uniform(0.4, 0.7), radius)
    pts = np.stack([radius * np.cos(ang), radius * np.sin(ang)], -1)
    return pts + rng.normal(0, 0.02, pts.shape)


def _distinctive_circle(seed=123, t_steps=48, n=150):
    """``tests/test_merge_sessions.py::_distinctive_circle`` at 150 points
    (capacity 152, the circle's): (jax clouds, port clouds, ground truth (x,
    y, theta), the world)."""
    rng = np.random.default_rng(seed)
    world = _distinctive_scan_2d(rng, n=n) * 2.5
    out, gt = [], []
    for k in range(t_steps):
        phi = 2 * math.pi * k / t_steps
        px, py = 1.5 * math.cos(phi), 1.5 * math.sin(phi)
        th = 0.5 * math.sin(phi)
        c, s = np.cos(th), np.sin(th)
        pts = (world - [px, py]) @ np.array([[c, -s], [s, c]])
        out.append(_pair(pts + rng.normal(0, 0.02, pts.shape), 152))
        gt.append((px, py, th))
    return [j for j, _ in out], [p for _, p in out], np.asarray(gt), world


def _stream(session, clouds, pipelined, cut=None, states=None):
    """Feed ``clouds``; the updates in scan order (pipelined: drained), and
    the serial session's ``state_dict`` after scan ``cut`` in ``states``."""
    ups = []
    for t, c in enumerate(clouds):
        ups.append(session.add_scan(c))
        if cut is not None and t == cut - 1:
            states.append(session.state_dict())
    if pipelined:
        ups.append(session.flush())
    return [u for u in ups if u is not None]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_updates(got, want, tol=TOL):
    assert len(got) == len(want)
    for t, (g, w) in enumerate(zip(got, want)):
        assert (g.is_keyframe, g.refined, g.num_closures) == (
            w.is_keyframe, w.refined, w.num_closures), t
        np.testing.assert_allclose(_np(g.pose.translation), _np(w.pose.translation), rtol=0,
                                   atol=tol, err_msg=f"scan {t}")
        np.testing.assert_allclose(_np(g.pose.rotation), _np(w.pose.rotation), rtol=0,
                                   atol=tol, err_msg=f"scan {t}")


def _assert_state(got: dict, want: dict, tol=TOL):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert (g.dtype, g.shape) == (w.dtype, w.shape), key
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def _assert_session(got, want, tol=TOL):
    assert got._loop_edges == want._loop_edges
    assert got._tried_pairs == want._tried_pairs
    np.testing.assert_allclose(_np(got.keyframe_poses.translation),
                               _np(want.keyframe_poses.translation), rtol=0, atol=tol)
    if want.closure_weights is None:
        assert got.closure_weights is None
    else:
        np.testing.assert_allclose(got.closure_weights, want.closure_weights, rtol=0, atol=tol)
    _assert_state(got.state_dict(), want.state_dict(), tol)


# -- the circle, serial and pipelined ------------------------------------------

SERIAL_KW = dict(CIRCLE_KW, loop_radius=2.5)  # single-pass, then two-pass from 12 closures
PIPED_KW = dict(CIRCLE_KW, translation_threshold=0.7, angle_threshold=0.3)
CUT = 30


@pytest.fixture(scope="module")
def circle(circle_scans):
    return circle_scans


def _inject(session, mod, xp):
    """``tests/test_online_slam.py:93``'s wrong closure: keyframe 10 meets
    keyframe 1 1.5 m off the consistent relative pose."""
    geo = J.geometry if mod is jslam else T.geometry
    ps = session.keyframe_poses
    a, b = 10, 1
    rel = geo.compose(geo.inverse(geo.RigidTransform(ps.rotation[a], ps.translation[a])),
                      geo.RigidTransform(ps.rotation[b], ps.translation[b]))
    session._loop_edges.append((a, b))
    session._loop_meas.append(geo.RigidTransform(rel.rotation,
                                                 rel.translation + xp.asarray([1.5, 0.0])))


@pytest.fixture(scope="module")
def serial_runs(circle):
    """The serial circle in both packages with the injected wrong closure
    (after 12 keyframes), each with its state after scan ``CUT``."""
    jscans, tscans = circle
    jm, tm = _methods()
    out = {}
    for name, mod, method, cfg, scans, kw, xp in (
            ("jax", jslam, jm, _jcfg(), jscans, {}, jnp),
            ("port", slam, tm, _tcfg(), tscans, {"device": "cpu"}, torch)):
        session = mod.OnlineSlam(method, cfg, **SERIAL_KW, **kw)
        ups, state = [], None
        for t, c in enumerate(scans):
            ups.append(session.add_scan(c))
            if len(session._kf_clouds) == 12 and not session._loop_edges:
                _inject(session, mod, xp)
            if t == CUT - 1:
                state = session.state_dict()
        out[name] = (session, ups, state)
    return out


def test_online_serial_matches_jax(serial_runs):
    (js, ju, _), (ts, tu, _) = serial_runs["jax"], serial_runs["port"]
    _assert_updates(tu, ju)
    counts = [u.num_closures for u in ju]
    assert any(u.refined for u in ju) and 0 < min(c for c in counts if c) < 12 <= counts[-1], \
        "the stream must cross the mapping threshold"
    _assert_session(ts, js)
    assert ts.finalize() == js.finalize()
    _assert_session(ts, js)
    assert float(ts._robust_scale_used) == pytest.approx(float(js._robust_scale_used), abs=TOL)
    # The injected closure is rejected and the loop still closes.
    assert ts._loop_edges[0] == (10, 1)
    assert ts.closure_weights[0] < 0.1 < ts.closure_weights[1:].min()
    assert float(np.linalg.norm(ts.keyframe_poses.translation[-1].numpy())) < 0.05


def test_jax_state_resumes_in_port(serial_runs, circle):
    """JAX's mid-stream state_dict, loaded into the port, continues within
    1e-8 m of JAX's uninterrupted run."""
    js, ju, jstate = serial_runs["jax"]
    _, tscans = circle
    resumed = slam.OnlineSlam(_methods()[1], _tcfg(), **SERIAL_KW, device="cpu")
    resumed.load_state(jstate)
    assert resumed._pose.translation.device.type == "cpu"
    _assert_updates(_stream(resumed, tscans[CUT:], False), ju[CUT:])
    assert resumed._loop_edges == js._loop_edges


@pytest.mark.parametrize("pipelined", [False, True])
def test_port_resume_is_bit_identical(serial_runs, circle, pipelined):
    """The port's own checkpoint continues bit for bit; a pipelined
    checkpoint drains the in-flight scan, so its uninterrupted twin drains
    at the same boundary."""
    _, tscans = circle
    kw = PIPED_KW if pipelined else SERIAL_KW
    if pipelined:
        full = slam.OnlineSlam(_methods()[1], _tcfg(), pipelined=True, **kw, device="cpu")
        for t, s in enumerate(tscans):
            full.add_scan(s)
            if t == CUT - 1:
                full.flush()
        full.flush()
        first = slam.OnlineSlam(_methods()[1], _tcfg(), pipelined=True, **kw, device="cpu")
        _stream(first, tscans[:CUT], False)
        state = first.state_dict()
    else:
        full, _, state = serial_runs["port"]
    resumed = slam.OnlineSlam(_methods()[1], _tcfg(), pipelined=pipelined, **kw, device="cpu")
    resumed.load_state(state)
    _stream(resumed, tscans[CUT:], pipelined)
    np.testing.assert_array_equal(full.keyframe_poses.translation.numpy(),
                                  resumed.keyframe_poses.translation.numpy())
    np.testing.assert_array_equal(full._pose.translation.numpy(),
                                  resumed._pose.translation.numpy())
    np.testing.assert_array_equal(full._cost_hist_np(), resumed._cost_hist_np())
    assert full._loop_edges == resumed._loop_edges


def test_online_pipelined_matches_jax(circle):
    jscans, tscans = circle
    jm, tm = _methods()
    js = jslam.OnlineSlam(jm, _jcfg(), pipelined=True, **PIPED_KW)
    ts = slam.OnlineSlam(tm, _tcfg(), pipelined=True, **PIPED_KW, device="cpu")
    ju, tu = _stream(js, jscans, True), _stream(ts, tscans, True)
    _assert_updates(tu, ju)
    flags = [u.is_keyframe for u in ju]
    assert 10 < sum(flags) < len(flags) and any(u.refined for u in ju)
    _assert_session(ts, js)
    assert ts.finalize() == js.finalize()
    _assert_session(ts, js)


@pytest.mark.parametrize("count", [0, 1, 4, 5, 11, 16])
def test_masked_median_bit_equal_to_numpy(rng, count):
    hist = rng.normal(1.0, 0.3, 16)
    got = slam._masked_median(torch.as_tensor(hist), torch.tensor(count, dtype=torch.int32))
    want = np.median(hist[16 - count:]) if count else np.inf
    assert float(got) == float(want)
    j = jslam._masked_median(jnp.asarray(hist), jnp.asarray(count, jnp.int32))
    assert float(got) == float(j)


@pytest.mark.parametrize("pipelined", [False, True])
def test_anomaly_retry_matches_jax(rng, pipelined):
    """``tests/test_online_slam.py:251``: a scrambled scan mid-stream makes
    the cost anomalous and fires the coarse retry, in both modes."""
    world = rng.uniform(-10, 10, (150, 2))
    pts = [world - np.asarray([0.08 * k, 0.0]) for k in range(13)]
    pts = [p + rng.normal(0, 0.01, p.shape) for p in pts]
    pts[8] = rng.uniform(-30, 30, pts[8].shape)
    pairs = [_pair(p, 152) for p in pts]
    kw = dict(translation_threshold=-1.0, angle_threshold=1e9, loop_every=999,
              loop_radius=1.5, loop_min_separation=10, pipelined=pipelined)
    jm, tm = _methods()
    js = jslam.OnlineSlam(jm, _jcfg(), **kw)
    ts = slam.OnlineSlam(tm, _tcfg(), **kw, device="cpu")
    ju = _stream(js, [j for j, _ in pairs], pipelined)
    tu = _stream(ts, [p for _, p in pairs], pipelined)
    hist = ts._cost_hist_np()
    assert hist.max() > 5 * np.median(hist)  # the retry's predicate held
    _assert_updates(tu, ju)
    np.testing.assert_allclose(hist, js._cost_hist_np(), rtol=0, atol=1e-12)


def test_online_3d_stream_matches_jax(rng):
    """A small 3D stream (trimmed 3D, 14 scans around a loop, closures at the
    revisit)."""
    world = rng.uniform(-8, 8, (120, 3)) * [1, 1, 0.4]
    pairs = []
    for k in range(14):
        phi = 2 * math.pi * k / 13
        yaw = 0.3 * math.sin(phi)
        c, s = math.cos(yaw), math.sin(yaw)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        p = np.array([1.5 * math.cos(phi), 1.5 * math.sin(phi), 0.0])
        pairs.append(_pair((world - p) @ rot + rng.normal(0, 0.01, world.shape), 120))
    kw = dict(translation_threshold=0.3, angle_threshold=0.2, loop_every=3, loop_radius=1.5,
              loop_min_separation=6, robust="gnc_gm", odometry_weight=100.0,
              loop_weight=100.0)
    jm, tm = _methods(3)
    js = jslam.OnlineSlam(jm, _jcfg(), **kw)
    ts = slam.OnlineSlam(tm, _tcfg(), **kw, device="cpu")
    ju = _stream(js, [j for j, _ in pairs], False)
    tu = _stream(ts, [p for _, p in pairs], False)
    _assert_updates(tu, ju)
    assert js.finalize() == ts.finalize()
    assert ts._loop_edges
    _assert_session(ts, js)


# -- descriptor detector, relocalization, merge ---------------------------------

DESC_KW = dict(CIRCLE_KW, loop_detector="descriptor", descriptor_range=45.0,
               descriptor_max_distance=0.4)


@pytest.fixture(scope="module")
def distinctive():
    return _distinctive_circle()


@pytest.fixture(scope="module")
def descriptor_sessions(distinctive):
    """Sessions a (the whole circle and on to scan 3 again: it revisits its
    start) and b (scans 20-47) of the distinctive circle with the descriptor
    detector, in both packages."""
    jscans, tscans, _, _ = distinctive
    jm, tm = _methods()
    out = {}
    for name, mod, method, cfg, scans, kw in (
            ("jax", jslam, jm, _jcfg(), jscans, {}),
            ("port", slam, tm, _tcfg(), tscans, {"device": "cpu"})):
        a = mod.OnlineSlam(method, cfg, **DESC_KW, **kw)
        b = mod.OnlineSlam(method, cfg, **DESC_KW, **kw)
        out[name] = (a, _stream(a, scans + scans[:4], False), b, _stream(b, scans[20:], False))
    return out


def test_online_descriptor_matches_jax(descriptor_sessions):
    ja, jau, jb, jbu = descriptor_sessions["jax"]
    ta, tau, tb, tbu = descriptor_sessions["port"]
    _assert_updates(tau, jau)
    _assert_updates(tbu, jbu)
    assert ta._loop_edges and ta._desc_queried == ja._desc_queried
    for got, want in ((ta, ja), (tb, jb)):
        np.testing.assert_allclose(torch.stack(got._kf_descs).numpy(),
                                   np.asarray(jnp.stack(want._kf_descs)), rtol=0, atol=1e-12)
        _assert_session(got, want)


def test_relocalize_matches_jax(descriptor_sessions, distinctive):
    """A kidnapped scan (yaw 0.9, never streamed) relocalized against
    session a's map: ``OnlineSlam.relocalize`` and the module function
    (descriptors rebuilt from the clouds)."""
    ja, _, _, _ = descriptor_sessions["jax"]
    ta, _, _, _ = descriptor_sessions["port"]
    _, _, _, world = distinctive
    rng = np.random.default_rng(5)
    c, s = np.cos(0.9), np.sin(0.9)
    jq, tq = _pair((world - [0.5, 0.3]) @ np.array([[c, -s], [s, c]])
                   + rng.normal(0, 0.03, world.shape), 152)
    want = ja.relocalize(jq, max_distance=0.45)
    got = ta.relocalize(tq, max_distance=0.45)
    assert want is not None and got.keyframe == want.keyframe
    np.testing.assert_allclose(got.pose.translation.numpy(), np.asarray(want.pose.translation),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got.pose.rotation.numpy(), np.asarray(want.pose.rotation),
                               rtol=0, atol=TOL)
    assert got.cost == pytest.approx(want.cost, abs=1e-10)
    assert got.descriptor_distance == pytest.approx(want.descriptor_distance, abs=1e-12)
    stack = T.PointCloud(torch.stack([k.points for k in ta._kf_clouds]),
                         torch.stack([k.count for k in ta._kf_clouds]))
    direct = slam.relocalize(tq, stack, ta.keyframe_poses, ta._method, ta._config,
                             descriptor_range=45.0, max_distance=0.45)
    np.testing.assert_allclose(direct.pose.translation.numpy(), got.pose.translation.numpy(),
                               rtol=0, atol=1e-12)
    assert slam.relocalize(tq, stack, ta.keyframe_poses, ta._method, ta._config,
                           descriptor_range=45.0, max_distance=0.01) is None
    with pytest.raises(ValueError, match="loop_detector='descriptor'"):
        slam.OnlineSlam(ta._method, ta._config, device="cpu").relocalize(tq)


def test_merge_descriptor_anchor_matches_jax(descriptor_sessions, distinctive):
    """``anchor=None``: the anchor from relocalizing b's first keyframe in
    a's database, then refinement to saturation."""
    ja, _, jb, _ = descriptor_sessions["jax"]
    ta, _, tb, _ = descriptor_sessions["port"]
    _, _, gt, _ = distinctive
    jm, jr = jslam.merge_sessions(ja, jb, relocalize_kwargs=dict(max_distance=0.45))
    tm, tr = slam.merge_sessions(ta, tb, relocalize_kwargs=dict(max_distance=0.45))
    assert (tr.keyframes, tr.new_closures, tr.refined) == (jr.keyframes, jr.new_closures,
                                                           jr.refined)
    assert tr.new_closures >= 1
    np.testing.assert_allclose(tr.anchor.translation.numpy(), np.asarray(jr.anchor.translation),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tr.anchor.translation.numpy(), gt[20, :2] - gt[0, :2], atol=0.12)
    _assert_session(tm, jm)


def test_merge_explicit_anchor_matches_jax(serial_runs, circle):
    """``tests/test_merge_sessions.py:56``'s rendezvous: a = the serial
    circle after scan 30 (restored from its checkpoint), b = scans 24-40,
    the anchor = a's pose of scan 24; the merged session keeps streaming.
    Session a's knobs carry ``closure_information``, so the merge's
    refinements weigh each closure by its target keyframe's geometry."""
    jscans, tscans = circle
    jm, tm = _methods()
    out = {}
    for name, mod, method, cfg, scans, kw in (
            ("jax", jslam, jm, _jcfg(), jscans, {}),
            ("port", slam, tm, _tcfg(), tscans, {"device": "cpu"})):
        session, ups, state = serial_runs[name]
        a = mod.OnlineSlam(method, cfg, **SERIAL_KW, closure_information=True, **kw)
        a.load_state(state)
        b = mod.OnlineSlam(method, cfg, **SERIAL_KW, **kw)
        _stream(b, scans[24:41], False)
        merged, report = mod.merge_sessions(a, b, anchor=ups[24].pose)
        out[name] = (merged, report, merged.add_scan(scans[1]))
    (jmg, jr, ju), (tmg, tr, tu) = out["jax"], out["port"]
    assert (tr.keyframes, tr.new_closures, tr.refined) == (jr.keyframes, jr.new_closures,
                                                           jr.refined)
    assert tr.refined and tmg._odo_weight_scale[tr.keyframes[0] - 1] == 1e-3
    _assert_updates([tu], [ju])
    _assert_session(tmg, jmg)
    with pytest.raises(ValueError, match="relocalization"):
        slam.merge_sessions(tmg, tmg)


# -- offline: run_slam ----------------------------------------------------------


def _stack(pairs):
    j = J.stack([a for a, _ in pairs])
    return j, convert.cloud_from_numpy(np.asarray(j.points), np.asarray(j.count), device="cpu")


def _assert_slam_result(got, want):
    np.testing.assert_array_equal(got.loop_edges.numpy(), np.asarray(want.loop_edges))
    np.testing.assert_allclose(got.poses.translation.numpy(), np.asarray(want.poses.translation),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got.poses.rotation.numpy(), np.asarray(want.poses.rotation),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got.graph_costs.numpy(), np.asarray(want.graph_costs),
                               rtol=1e-8, atol=1e-10)
    if want.edge_weights is None:
        assert got.edge_weights is None
    else:
        np.testing.assert_allclose(got.edge_weights.numpy(), np.asarray(want.edge_weights),
                                   rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def noisy_loop():
    """``tests/test_descriptor.py:208``'s noisy 14-scan loop (the revisit:
    the last scan at the first's place), as a JAX and a port stack."""
    rng = np.random.default_rng(123)
    world = _distinctive_scan_2d(rng, n=150) * 2.5
    pairs = []
    for k in range(14):
        phi = 2 * math.pi * k / 13
        px, py, th = 1.5 * math.cos(phi), 1.5 * math.sin(phi), 0.4 * math.sin(phi)
        c, s = np.cos(th), np.sin(th)
        pts = (world - [px, py]) @ np.array([[c, -s], [s, c]])
        pairs.append(_pair(pts + rng.normal(0, 0.08, pts.shape), 152))
    return _stack(pairs)


RUN_SLAM = {
    "radius gnc_gm": dict(loop_radius=1.0, loop_min_separation=8, loop_weight=100.0,
                          robust="gnc_gm"),
    "descriptor": dict(loop_detector="descriptor", descriptor_range=30.0,
                       descriptor_max_distance=0.2, loop_min_separation=8, loop_weight=100.0),
}


@pytest.mark.parametrize("case", sorted(RUN_SLAM))
def test_run_slam_matches_jax(noisy_loop, case):
    jst, tst = noisy_loop
    jm, tm = _methods()
    want = jslam.run_slam(jst, jm, _jcfg(), **RUN_SLAM[case])
    got = slam.run_slam(tst, tm, _tcfg(), **RUN_SLAM[case])
    assert len(got.loop_edges) >= 1
    _assert_slam_result(got, want)
    if case == "descriptor":
        with pytest.raises(ValueError, match="descriptor_range"):
            slam.run_slam(tst, tm, _tcfg(), loop_detector="descriptor")
        with pytest.raises(ValueError, match="loop_detector"):
            slam.run_slam(tst, tm, _tcfg(), loop_detector="magic")


# -- departures, validation -----------------------------------------------------


def test_load_state_clears_diagnostics_departure(serial_runs):
    """Departure from ``icp_tpu/slam.py:1024``: JAX's ``load_state`` keeps
    the previous session's closure weights and robust scale; the port's
    clears them (they described a graph that is gone)."""
    (js, _, jstate), (ts, _, tstate) = serial_runs["jax"], serial_runs["port"]
    assert js.closure_weights is not None and ts.closure_weights is not None
    js.load_state(jstate)
    ts.load_state(tstate)
    assert js.closure_weights is not None and js._robust_scale_used is not None
    assert ts.closure_weights is None and ts._robust_scale_used is None


def test_gnc_gm_mapping_kernel_refused_departure():
    """Departure from ``icp_tpu/slam.py:289,445``: JAX builds a session with
    ``mapping_kernel='gnc_gm'``, and only its first mapping-scale refinement
    fails, in the fused two-pass solve with ``early_exit_tol`` (the call at
    ``icp_tpu/slam.py:285``); the port refuses it when the session is
    built."""
    jm, tm = _methods()
    kw = dict(CIRCLE_KW, mapping_kernel="gnc_gm")
    jslam.OnlineSlam(jm, _jcfg(), **kw)
    graph = J.pose_graph.graph_from_trajectory(
        J.geometry.identity(2, (3,), dtype=jnp.float64),
        J.geometry.identity(2, (2,), dtype=jnp.float64),
        loop_edges=jnp.asarray([[0, 2]], jnp.int32),
        loop_measurements=J.geometry.identity(2, (1,), dtype=jnp.float64))
    with pytest.raises(ValueError, match="early_exit_tol"):
        J.pose_graph.robust_solve_fused(graph, jnp.asarray([False, False, True]),
                                        kernel="gnc_gm", robust_scale=1.0, early_exit_tol=1e-6)
    with pytest.raises(ValueError, match="mapping_kernel='gnc_gm'"):
        slam.OnlineSlam(tm, _tcfg(), **kw, device="cpu")
    # Where the mapping-scale solve can never run, both accept it.
    slam.OnlineSlam(tm, _tcfg(), **dict(kw, scale_passes=1), device="cpu")
    slam.OnlineSlam(tm, _tcfg(), **dict(kw, robust="none"), device="cpu")


def test_validation_and_devices(circle):
    _, tscans = circle
    tm = _methods()[1]
    with pytest.raises(ValueError, match="loop_detector"):
        slam.OnlineSlam(tm, _tcfg(), loop_detector="nope", device="cpu")
    with pytest.raises(ValueError, match="descriptor_range"):
        slam.OnlineSlam(tm, _tcfg(), loop_detector="descriptor", device="cpu")
    with pytest.raises(ValueError, match="scale_passes"):
        slam.OnlineSlam(tm, _tcfg(), scale_passes="two", device="cpu")
    s = slam.OnlineSlam(tm, _tcfg(), device="cpu")
    assert s.state_dict() == {"num_keyframes": 0} and not s.finalize()
    with pytest.raises(ValueError, match="no keyframes"):
        s.keyframe_poses  # noqa: B018
    meta = T.PointCloud(tscans[0].points.to("meta"), tscans[0].count.to("meta"))
    with pytest.raises(ValueError, match="session on cpu"):
        s.add_scan(meta)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            slam.OnlineSlam(tm, _tcfg())  # the card by default


@pytest.mark.cuda
@pytest.mark.parametrize("pipelined", [False, True])
def test_online_on_card_agrees_with_cpu(cuda_device, circle, pipelined):
    """The circle streamed on the card (float32) against the CPU float64 run:
    the same keyframe decisions and closures, keyframe poses within 2e-3 m."""
    _, tscans = circle
    tm = _methods()[1]
    kw = PIPED_KW if pipelined else SERIAL_KW
    cpu = slam.OnlineSlam(tm, _tcfg(), pipelined=pipelined, **kw, device="cpu")
    card = slam.OnlineSlam(tm, _tcfg(), pipelined=pipelined, **kw, device=cuda_device)
    cu = _stream(cpu, tscans, pipelined)
    gu = _stream(card, [T.PointCloud(c.points.float().to(cuda_device), c.count.to(cuda_device))
                        for c in tscans], pipelined)
    assert [u.is_keyframe for u in gu] == [u.is_keyframe for u in cu]
    assert card._loop_edges == cpu._loop_edges
    np.testing.assert_allclose(card.keyframe_poses.translation.double().cpu().numpy(),
                               cpu.keyframe_poses.translation.numpy(), atol=2e-3)
