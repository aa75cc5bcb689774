"""``icp_tpu_torch.vis`` against ``icp_tpu.vis`` on the CPU in float64:
``render_registration``'s frame dumps (iteration, cost, rotation,
translation) on scan1, vanilla and trimmed, within 1e-9, with the same
frames written; ``render_trajectory`` and ``assemble_animation`` (GIF and
HTML) write their files."""

import os

import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T
from icp_tpu import vis as jvis
from icp_tpu_torch import vis

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCAN1 = [f"{REPO}/ex_data/scan1/first.csv", f"{REPO}/ex_data/scan1/second.csv"]
ITERATIONS, EVERY = 4, 2


@pytest.fixture(scope="module")
def scan1():
    jax_clouds = [J.parse_lidar_scan(p, dtype=np.float64) for p in SCAN1]
    port_clouds = [T.parse_lidar_scan(p, device="cpu") for p in SCAN1]
    return jax_clouds, port_clouds


@pytest.mark.parametrize("name", ["vanilla", "trimmed"])
def test_render_registration_matches_jax(scan1, tmp_path, name):
    (ja, jb), (ta, tb) = scan1
    logged = []
    want = jvis.render_registration(J.from_method(name, 2), ja, jb, J.identity(2, dtype=np.float64),
                                    str(tmp_path / "jax"), iterations=ITERATIONS, every=EVERY)
    got = vis.render_registration(T.from_method(name, 2), ta, tb, T.identity(2, device="cpu"),
                                  str(tmp_path / "port"), iterations=ITERATIONS, every=EVERY,
                                  log=logged.append, view_conf={"window_width": 300,
                                                                "window_height": 200,
                                                                "view_scale": 20})
    assert [d.iteration for d in got] == [d.iteration for d in want] == list(range(ITERATIONS + 1))
    assert logged == got
    for g, w in zip(got, want):
        assert g.cost == pytest.approx(w.cost, rel=0, abs=1e-9)
        np.testing.assert_allclose(g.rotation, np.asarray(w.rotation), rtol=0, atol=1e-9)
        np.testing.assert_allclose(g.translation, np.asarray(w.translation), rtol=0, atol=1e-9)
    frames = sorted(os.listdir(tmp_path / "port"))
    assert frames == sorted(os.listdir(tmp_path / "jax")) == [
        f"frame_{i:04d}.png" for i in range(0, ITERATIONS + 1, EVERY)]
    if name == "trimmed":  # vanilla's correspondences are fixed at init
        assert got[-1].cost < got[0].cost


def test_registration_frames_step_without_drawing(scan1):
    _, (ta, tb) = scan1
    method = T.from_method("trimmed", 2)
    dumps = [d for _, d in vis.registration_frames(method, ta, tb, T.identity(2, device="cpu"), 3)]
    result, _ = T.converge(method, ta, tb, T.identity(2, device="cpu"),
                           T.DriverConfig(max_iterations=3))
    np.testing.assert_array_equal(dumps[-1].translation, result.transform.translation.numpy())


def test_render_trajectory_and_animations(scan1, tmp_path):
    _, (ta, tb) = scan1
    poses = T.geometry.from_angle_2d(torch.tensor([0.0, 0.1, 0.2], dtype=torch.float64),
                                     torch.tensor([[0.0, 0.0], [1.0, 0.0], [2.0, 0.5]],
                                                  dtype=torch.float64))
    scans = T.stack([ta, tb, ta])
    vis.render_trajectory(str(tmp_path / "traj.png"), poses, scans=scans, keyframes=[0, 2])
    assert (tmp_path / "traj.png").stat().st_size > 0
    dumps = vis.render_registration(T.from_method("vanilla", 2), ta, tb,
                                     T.identity(2, device="cpu"), str(tmp_path / "frames"),
                                     iterations=2, light_mode=True)
    gif = vis.assemble_animation(str(tmp_path / "frames"), str(tmp_path / "a.gif"), dumps, fps=0)
    html = vis.assemble_animation(str(tmp_path / "frames"), str(tmp_path / "a.html"), dumps)
    assert os.path.getsize(gif) > 0 and "frame" not in os.path.basename(gif)
    text = open(html).read()
    assert text.count('"iter"') == 3 and "__FRAMES__" not in text
    with pytest.raises(ValueError, match="unsupported animation format"):
        vis.assemble_animation(str(tmp_path / "frames"), str(tmp_path / "a.mp4"))
    with pytest.raises(FileNotFoundError):
        vis.assemble_animation(str(tmp_path / "none"), str(tmp_path / "b.gif"))


@pytest.mark.cuda
def test_registration_frames_on_card(cuda_device, scan1):
    """The frame stepping on the card (float32; the 1-NN kernel in init and
    in each step) against the CPU float64 frames: translations within
    2e-3 m.  (Drawing needs matplotlib, which the card's host may lack.)"""
    _, (ta, tb) = scan1
    card = [T.PointCloud(c.points.float().to(cuda_device), c.count.to(cuda_device))
            for c in (ta, tb)]
    got = [d for _, d in vis.registration_frames(
        T.from_method("trimmed", 2), *card,
        T.identity(2, dtype=torch.float32, device=cuda_device), ITERATIONS)]
    want = [d for _, d in vis.registration_frames(T.from_method("trimmed", 2), ta, tb,
                                                  T.identity(2, device="cpu"), ITERATIONS)]
    assert len(got) == len(want) == ITERATIONS + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.translation, w.translation, atol=2e-3)
