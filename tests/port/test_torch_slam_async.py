"""``OnlineSlam(async_refine=True)`` of ``icp_tpu_torch.slam`` on the CPU in
float64, on the 49-scan circle of ``tests/test_online_slam.py`` (capacity
152), against the JAX package and against the port's own synchronous runs.

"Pinned" runs fix the apply timing: before each ``add_scan`` the port waits
until its outstanding solve is ready (its worker's future and, on the card,
the solve's end event) and the JAX session on its outstanding solve
(``jax.block_until_ready(online._async_solve)``, a private attribute read
by the test only), so each solve is applied at the next scan.

* The port's pinned serial run against JAX's: per update ``is_keyframe``,
  ``refined`` and ``num_closures`` exact and the live pose within 1e-8 m;
  closures and tried pairs exact; keyframe poses, odometry measurements,
  closure weights and the finalized state within 1e-8.
* The port's pinned runs, serial and pipelined, against its synchronous
  runs: keyframe flags, closures and tried pairs exact, the odometry
  measurements and the finalized keyframes within 1e-8 m.
* The departure from ``icp_tpu/slam.py:873-898``: in the JAX package a
  pipelined correction reaches only the scan before the one in flight, so
  its odometry measurements leave its synchronous run's; the port's do not.
* Unpinned: ``tests/test_online_slam.py:410-477``'s quality limits.
* Lifecycle: ``load_state`` drops an outstanding solve (the JAX package
  keeps it, ``ADVICE.md``'s ``load_state`` finding); ``state_dict`` and
  ``finalize`` apply one; a failure in the worker raises at the apply; a
  solve is ready only once its end event has completed.
"""

import jax
import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T
from icp_tpu import slam as jslam
from icp_tpu_torch import slam

TOL = 1e-8
CIRCLE_KW = dict(translation_threshold=0.4, angle_threshold=0.15, loop_every=4, loop_radius=1.5,
                 loop_min_separation=10, robust="gnc_gm", robust_scale="auto",
                 odometry_weight=100.0, loop_weight=100.0)
# Refinements accept closures from scan 44, and keyframes follow the first
# mid-stream apply (scan 45): the window the pipelined fault needs.
ASYNC_KW = dict(CIRCLE_KW, loop_radius=2.5)
# The JAX package's background compiles of the next solver buckets (on by
# default with async_refine) change no result (tests/test_online_slam.py's
# test_online_slam_bucket_prefetch_inert); off, they cost the tests nothing.
NO_PREFETCH = {"prefetch_buckets": False}


def _cfg(pkg):
    return pkg.DriverConfig(max_iterations=50, angle_tolerance=1e-5, translation_tolerance=1e-5)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pin(session):
    """Wait for an outstanding solve (each package's own way)."""
    pend = session._async_solve
    if pend is None:
        return
    if isinstance(session, slam.OnlineSlam):
        pend.block_until_ready()
    else:
        jax.block_until_ready(pend)


def _stream(session, clouds, pinned):
    ups = []
    for c in clouds:
        if pinned:
            _pin(session)
        ups.append(session.add_scan(c))
    if session._pipelined:
        ups.append(session.flush())
    return [u for u in ups if u is not None]


def _record(session, ups):
    """What the tests compare, before and after ``finalize``."""
    rec = {
        "flags": [(u.is_keyframe, u.refined, u.num_closures) for u in ups],
        "live": np.stack([_np(u.pose.translation) for u in ups]),
        "live_rot": np.stack([_np(u.pose.rotation) for u in ups]),
        "loop_edges": list(session._loop_edges),
        "tried": set(session._tried_pairs),
        "odo": _np(session._folded_odo().translation),
    }
    rec["finalized"] = session.finalize()
    rec["outstanding"] = session._async_solve is not None
    rec["kf"] = _np(session.keyframe_poses.translation)
    rec["pose"] = _np(session._pose.translation)
    rec["weights"] = session.closure_weights
    return rec


@pytest.fixture(scope="module")
def runs(circle_scans, trimmed_pair):
    """The circle under ASYNC_KW: the port synchronous and pinned-async,
    serial and pipelined; the JAX package pinned-async serial, and
    synchronous and pinned-async pipelined."""
    jscans, tscans = circle_scans
    jm, tm = trimmed_pair
    out = {}
    for name, pipelined, async_refine in (("sync serial", False, False),
                                          ("async serial", False, True),
                                          ("sync pipelined", True, False),
                                          ("async pipelined", True, True)):
        session = slam.OnlineSlam(tm, _cfg(T), pipelined=pipelined, async_refine=async_refine,
                                  device="cpu", **ASYNC_KW)
        out["port", name] = _record(session, _stream(session, tscans, async_refine))
        if name == "sync serial":
            continue  # the JAX package's own sync serial run is test_torch_slam's
        session = jslam.OnlineSlam(jm, _cfg(J), pipelined=pipelined, async_refine=async_refine,
                                   **NO_PREFETCH, **ASYNC_KW)
        out["jax", name] = _record(session, _stream(session, jscans, async_refine))
    return out


def test_async_serial_matches_jax(runs):
    got, want = runs["port", "async serial"], runs["jax", "async serial"]
    assert got["flags"] == want["flags"]
    assert any(f[1] for f in got["flags"]), "a correction must land mid-stream"
    np.testing.assert_allclose(got["live"], want["live"], rtol=0, atol=TOL)
    np.testing.assert_allclose(got["live_rot"], want["live_rot"], rtol=0, atol=TOL)
    assert got["loop_edges"] == want["loop_edges"] and got["tried"] == want["tried"]
    np.testing.assert_allclose(got["odo"], want["odo"], rtol=0, atol=TOL)
    assert got["finalized"] == want["finalized"]
    assert not got["outstanding"] and not want["outstanding"]
    for key in ("kf", "pose", "weights"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=TOL, err_msg=key)


@pytest.mark.parametrize("mode", ["serial", "pipelined"])
def test_async_matches_own_sync_run(runs, mode):
    """Pinned, each solve lands one scan after the synchronous run's
    re-anchor; the left-compose correction makes every later pose equal."""
    got, want = runs["port", f"async {mode}"], runs["port", f"sync {mode}"]
    assert [f[0] for f in got["flags"]] == [f[0] for f in want["flags"]]
    assert [f[2] for f in got["flags"]] == [f[2] for f in want["flags"]]
    sync_refines = [t for t, f in enumerate(want["flags"]) if f[1]]
    assert [t for t, f in enumerate(got["flags"]) if f[1]] == [
        t + 1 for t in sync_refines if t + 1 < len(want["flags"])]
    assert got["loop_edges"] == want["loop_edges"] and got["tried"] == want["tried"]
    np.testing.assert_allclose(got["odo"], want["odo"], rtol=0, atol=TOL)
    # The live pose differs only on the scan whose re-anchor is pending.
    same = [t for t in range(len(want["flags"])) if t not in sync_refines]
    np.testing.assert_allclose(got["live"][same], want["live"][same], rtol=0, atol=TOL)
    for key in ("kf", "pose", "weights"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=TOL, err_msg=key)


def test_pipelined_async_departure(runs):
    """Departure from ``icp_tpu/slam.py:873-898``: the JAX package launches
    scan t from the uncorrected pose and then applies the solve, so scan t
    and every scan after it stay in the old frame while the keyframes move;
    the odometry measurements promoted from them, which no later solve
    revisits, leave the synchronous run's.  The port applies the solve
    before the launch: its measurements and keyframes stay within 1e-8 m
    of its synchronous run (and the two synchronous runs agree)."""
    jax_async, jax_sync = runs["jax", "async pipelined"], runs["jax", "sync pipelined"]
    port_async, port_sync = runs["port", "async pipelined"], runs["port", "sync pipelined"]
    np.testing.assert_allclose(port_sync["kf"], jax_sync["kf"], rtol=0, atol=TOL)
    assert [f[0] for f in jax_async["flags"]] == [f[0] for f in jax_sync["flags"]]
    assert np.abs(jax_async["odo"] - jax_sync["odo"]).max() > 1e-7
    assert np.abs(jax_async["kf"] - jax_sync["kf"]).max() > 1e-7
    assert np.abs(port_async["odo"] - port_sync["odo"]).max() <= TOL
    assert np.abs(port_async["kf"] - port_sync["kf"]).max() <= TOL


@pytest.fixture(scope="module")
def unpinned(circle_scans, trimmed_pair):
    """``tests/test_online_slam.py:410-477``'s runs: CIRCLE_KW, synchronous
    and asynchronous serial, asynchronous pipelined, no pinning."""
    _, tscans = circle_scans
    tm = trimmed_pair[1]
    out = {}
    for name, pipelined, async_refine in (("sync", False, False), ("async", False, True),
                                          ("async pipelined", True, True)):
        session = slam.OnlineSlam(tm, _cfg(T), pipelined=pipelined, async_refine=async_refine,
                                  device="cpu", **CIRCLE_KW)
        ups = _stream(session, tscans, pinned=False)
        fin = session.finalize()
        out[name] = (session, any(u.refined for u in ups) or fin)
    return out


def test_async_refine_matches_sync_quality(unpinned):
    (sync, _), (async_run, any_refined) = unpinned["sync"], unpinned["async"]
    assert async_run._async_solve is None  # finalize applied it
    assert any_refined
    assert len(async_run._loop_edges) >= 1
    assert float(torch.linalg.vector_norm(sync._pose.translation)) < 0.05
    assert float(torch.linalg.vector_norm(async_run._pose.translation)) < 0.05
    ks, ka = sync.keyframe_poses.translation, async_run.keyframe_poses.translation
    n = min(len(ks), len(ka))
    assert float(torch.linalg.vector_norm(ks[:n] - ka[:n], dim=-1).max()) < 0.1


def test_async_refine_pipelined_quality(unpinned):
    online, _ = unpinned["async pipelined"]
    assert online._async_solve is None
    assert len(online._loop_edges) >= 1
    assert float(torch.linalg.vector_norm(online._pose.translation)) < 0.05


# -- lifecycle ------------------------------------------------------------------


def _inject(session, mod, xp):
    """``tests/test_online_slam.py:93``'s wrong closure (keyframe 10 meets
    keyframe 1 1.5 m off), so that the next refinement solves."""
    geo = J.geometry if mod is jslam else T.geometry
    ps = session.keyframe_poses
    rel = geo.compose(geo.inverse(geo.RigidTransform(ps.rotation[10], ps.translation[10])),
                      geo.RigidTransform(ps.rotation[1], ps.translation[1]))
    session._loop_edges.append((10, 1))
    session._loop_meas.append(geo.RigidTransform(rel.rotation,
                                                 rel.translation + xp.asarray([1.5, 0.0])))


def _outstanding(mod, method, cfg, scans, xp, **kw):
    """A session with a solve dispatched on its last scan (scan 12, the
    refinement after the injection)."""
    kw = kw or NO_PREFETCH
    session = mod.OnlineSlam(method, cfg, async_refine=True, **kw, **CIRCLE_KW)
    for t, c in enumerate(scans[:13]):
        session.add_scan(c)
        if t == 11:
            _inject(session, mod, xp)
    assert session._async_solve is not None
    return session


def test_load_state_drops_outstanding_solve_departure(circle_scans, trimmed_pair):
    """Departure from ``icp_tpu/slam.py:1024`` (``ADVICE.md``: ``load_state``
    does not reset ``_async_solve``): JAX keeps the outstanding solve and
    the next force-apply writes the stale solve over the restored
    keyframes; the port waits it out and drops it."""
    import jax.numpy as jnp

    jscans, tscans = circle_scans
    jm, tm = trimmed_pair
    js = _outstanding(jslam, jm, _cfg(J), jscans, jnp)
    ts = _outstanding(slam, tm, _cfg(T), tscans, torch, device="cpu")
    base = jslam.OnlineSlam(jm, _cfg(J), **CIRCLE_KW)
    for c in jscans[:8]:
        base.add_scan(c)
    state = base.state_dict()
    js.load_state(state)
    ts.load_state(state)
    assert js._async_solve is not None and ts._async_solve is None
    # JAX's next force-apply writes the stale solve's 13 keyframes over the
    # restored 8; the port's state is the restored one.
    assert np.asarray(js.state_dict()["kf_trans"]).shape == (13, 2)
    np.testing.assert_array_equal(ts.state_dict()["kf_trans"], state["kf_trans"])


def test_state_dict_and_finalize_apply_an_outstanding_solve(circle_scans, trimmed_pair):
    import jax.numpy as jnp

    jscans, tscans = circle_scans
    jm, tm = trimmed_pair
    for mod, method, cfg, scans, xp, kw in (
            (jslam, jm, _cfg(J), jscans, jnp, {}),
            (slam, tm, _cfg(T), tscans, torch, {"device": "cpu"})):
        session = _outstanding(mod, method, cfg, scans, xp, **kw)
        assert session.closure_weights is None
        state = session.state_dict()
        assert session._async_solve is None and session.closure_weights is not None
        assert state["loop_edges"].tolist() == [[10, 1]]
        session = _outstanding(mod, method, cfg, scans, xp, **kw)
        assert session.finalize() and session._async_solve is None
    # The port's applied state equals the JAX package's.
    got = _outstanding(slam, tm, _cfg(T), tscans, torch, device="cpu").state_dict()
    want = _outstanding(jslam, jm, _cfg(J), jscans, jnp).state_dict()
    for key in ("kf_trans", "pose_trans", "odo_trans"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=TOL, err_msg=key)


def test_worker_failure_raises_at_the_apply(circle_scans, trimmed_pair, monkeypatch):
    """A solve that raises in the worker raises where it is applied, and the
    session does not solve again on its own thread."""
    _, tscans = circle_scans
    calls = []

    def failing(*args):
        calls.append(args)
        raise FloatingPointError("solve failed")

    monkeypatch.setattr(slam, "_solve_single", failing)
    session = _outstanding(slam, trimmed_pair[1], _cfg(T), tscans, torch, device="cpu")
    with pytest.raises(FloatingPointError, match="solve failed"):
        session.finalize()
    assert len(calls) == 1 and session._async_solve is None


def test_ready_waits_for_the_solve_end_event():
    """On the card a solve is ready (JAX's ``is_ready()``) only when the
    worker has returned and the event it recorded after the solve's kernels
    has completed; ``block_until_ready`` waits for both."""
    from concurrent.futures import Future

    class Event:  # a CUDA event's query / synchronize
        def __init__(self):
            self.done = False

        def query(self):
            return self.done

        def synchronize(self):
            self.done = True

    future = Future()
    pend = slam._AsyncSolve(future, (), (Event(), Event()))
    assert not pend.ready()
    future.set_result(None)
    assert not pend.ready()  # the worker returned; its kernels may still run
    pend.block_until_ready()
    assert pend.ready()
    assert slam._AsyncSolve(future, ()).ready()  # on the CPU: the future alone


def test_async_keyword_reaches_merged_session(circle_scans, trimmed_pair):
    """``merge_sessions`` builds its session with ``a``'s ``async_refine``
    and lands its solves before counting a round's closures."""
    _, tscans = circle_scans
    tm = trimmed_pair[1]
    a = slam.OnlineSlam(tm, _cfg(T), async_refine=True, device="cpu", **CIRCLE_KW)
    b = slam.OnlineSlam(tm, _cfg(T), device="cpu", **CIRCLE_KW)
    for c in tscans[:6]:
        a.add_scan(c)
    for c in tscans[6:12]:
        b.add_scan(c)
    merged, report = slam.merge_sessions(a, b, anchor=T.identity(2, device="cpu"))
    assert merged._async_refine and merged._async_solve is None
    assert merged.closure_weights is not None and report.keyframes == (6, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("pipelined", [False, True])
def test_async_on_card_agrees_with_cpu(cuda_device, circle_scans, trimmed_pair, pipelined):
    """The pinned asynchronous stream on the card (float32, the solve on the
    worker's stream) against the CPU float64 one: the same keyframe
    decisions and closures, keyframe poses within 2e-3 m."""
    _, tscans = circle_scans
    tm = trimmed_pair[1]
    cpu = slam.OnlineSlam(tm, _cfg(T), pipelined=pipelined, async_refine=True, device="cpu",
                          **ASYNC_KW)
    card = slam.OnlineSlam(tm, _cfg(T), pipelined=pipelined, async_refine=True,
                           device=cuda_device, **ASYNC_KW)
    cu = _stream(cpu, tscans, pinned=True)
    gu = _stream(card, [T.PointCloud(c.points.float().to(cuda_device), c.count.to(cuda_device))
                        for c in tscans], pinned=True)
    assert [u.is_keyframe for u in gu] == [u.is_keyframe for u in cu]
    cpu.finalize()
    card.finalize()
    assert card._loop_edges == cpu._loop_edges and card._async_solve is None
    np.testing.assert_allclose(card.keyframe_poses.translation.double().cpu().numpy(),
                               cpu.keyframe_poses.translation.numpy(), atol=2e-3)


# -- a serial checkpoint resumed in pipelined mode -------------------------------

RESUME_KW = dict(CIRCLE_KW, translation_threshold=0.7, angle_threshold=0.3)
RESUME_CUT = 21  # scan 20, the checkpoint's live scan, is not a keyframe


def test_serial_checkpoint_into_pipelined_departure(circle_scans, trimmed_pair):
    """Departure from ``icp_tpu/slam.py:1087-1096``: a serial checkpoint has
    no last raw scan, so the next scan registers against the last keyframe;
    the JAX package then chains it from the checkpoint's live pose, the
    port from that keyframe's pose.  The port's next pose equals the serial
    run's own next pose; the JAX package's is off by the live scan's offset
    from the keyframe."""
    jscans, tscans = circle_scans
    jm, tm = trimmed_pair
    serial = jslam.OnlineSlam(jm, _cfg(J), **RESUME_KW)
    ups = [serial.add_scan(c) for c in jscans[:RESUME_CUT]]
    assert not ups[-1].is_keyframe
    state = serial.state_dict()
    want = _np(serial.add_scan(jscans[RESUME_CUT]).pose.translation)
    got = {}
    for name, session, scan in (
            ("port", slam.OnlineSlam(tm, _cfg(T), pipelined=True, device="cpu", **RESUME_KW),
             tscans[RESUME_CUT]),
            ("jax", jslam.OnlineSlam(jm, _cfg(J), pipelined=True, **RESUME_KW),
             jscans[RESUME_CUT])):
        session.load_state(state)
        assert session.add_scan(scan) is None
        got[name] = _np(session.flush().pose.translation)
    np.testing.assert_allclose(got["port"], want, rtol=0, atol=TOL)
    assert np.linalg.norm(got["jax"] - want) > 0.1


def test_pipelined_jax_checkpoint_resumes_in_port(circle_scans, trimmed_pair):
    """A pipelined checkpoint (it carries the last raw scan) takes the
    reference's path: the port continues within 1e-8 m of the JAX
    package's uninterrupted run."""
    jscans, tscans = circle_scans
    jm, tm = trimmed_pair
    jax_run = jslam.OnlineSlam(jm, _cfg(J), pipelined=True, **RESUME_KW)
    for c in jscans[:RESUME_CUT]:
        jax_run.add_scan(c)
    state = jax_run.state_dict()
    assert "prev_points" in state
    port = slam.OnlineSlam(tm, _cfg(T), pipelined=True, device="cpu", **RESUME_KW)
    port.load_state(state)
    want = _stream(jax_run, jscans[RESUME_CUT:RESUME_CUT + 8], pinned=False)
    got = _stream(port, tscans[RESUME_CUT:RESUME_CUT + 8], pinned=False)
    assert [u.is_keyframe for u in got] == [u.is_keyframe for u in want]
    np.testing.assert_allclose(np.stack([_np(u.pose.translation) for u in got]),
                               np.stack([_np(u.pose.translation) for u in want]), rtol=0, atol=TOL)
