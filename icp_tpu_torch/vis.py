"""Offline visualization: the headless replacement of the SDL LidarView.

Port of :mod:`icp_tpu.vis`.  The interactive SDL window
(``vis/lidar_view.cpp``) becomes an offline PNG renderer in its visual
language (``lidar_view.cpp:95-139``): target cloud blue, transformed source
red, correspondence lines green shaded by match cost, large centroid
markers for both clouds.  :func:`render_registration` steps the method one
iteration per frame (``lidar_view.cpp:136-138``) on the clouds' device, so
on the card the 1-NN kernel runs in ``init`` and in every step; the clouds
move to the host only to be drawn.  The D-key debug dump
(``lidar_view.cpp:52-60``) becomes one :class:`FrameDump` per frame.
``matplotlib`` (and ``PIL`` for GIFs) are imported only by the functions
that draw.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from . import geometry
from .cloud import PointCloud
from .geometry import RigidTransform
from .methods.base import Method


@dataclasses.dataclass
class FrameDump:
    """Per-iteration debug record: the D-key dump fields
    (``lidar_view.cpp:52-60``: iteration count, cost, transform)."""

    iteration: int
    cost: float
    rotation: np.ndarray
    translation: np.ndarray


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _valid(points: torch.Tensor, count) -> np.ndarray:
    return _host(points[: int(count)])


def render_frame(
    ax,
    source: PointCloud,
    target: PointCloud,
    transform: RigidTransform,
    match_idx=None,
    match_cost=None,
    light_mode: bool = False,
):
    """Draw one registration frame onto a matplotlib Axes."""
    bg = "white" if light_mode else "black"
    ax.set_facecolor(bg)

    tgt = _valid(target.points, target.count)
    src = _valid(geometry.apply(transform, source.points), source.count)

    # Match lines first (underneath), green shaded by relative cost
    # (``lidar_view.cpp:65-93`` draw_matches).
    if match_idx is not None:
        idx = _host(match_idx)[: len(src)]
        pairs = tgt[np.clip(idx, 0, len(tgt) - 1)]
        if match_cost is not None:
            cost = _host(match_cost)[: len(src)]
            finite = np.isfinite(cost)
            cmax = cost[finite].max() if finite.any() else 1.0
            shade = np.where(finite, cost / max(cmax, 1e-12), 1.0)
        else:
            shade = np.zeros(len(src))
        for s, p, c in zip(src, pairs, shade):
            ax.plot(
                [s[0], p[0]], [s[1], p[1]],
                color=(0.0, 1.0 - 0.7 * c, 0.0), linewidth=0.4, zorder=1,
            )

    ax.scatter(tgt[:, 0], tgt[:, 1], s=4, c="blue", zorder=2, label="target")
    ax.scatter(src[:, 0], src[:, 1], s=4, c="red", zorder=3, label="source")

    a_cm = _host(geometry.apply(
        transform, geometry.masked_centroid(source.points, source.mask)[None, :]))[0]
    b_cm = _host(geometry.masked_centroid(target.points, target.mask))
    ax.scatter([a_cm[0]], [a_cm[1]], s=150, facecolors="none", edgecolors="red", zorder=4)
    ax.scatter([b_cm[0]], [b_cm[1]], s=150, facecolors="none", edgecolors="blue", zorder=4)
    ax.set_aspect("equal")


def registration_frames(
    method: Method,
    source: PointCloud,
    target: PointCloud,
    guess: RigidTransform,
    iterations: int = 20,
):
    """The stepping of :func:`render_registration` without the drawing:
    yields ``(state, FrameDump)`` for iterations ``0..iterations``, the
    method's ``init`` first and one ``iterate`` between frames, on the
    clouds' device."""
    state = method.init(source, target, guess)
    for it in range(iterations + 1):
        yield state, FrameDump(
            iteration=it,
            cost=float(method.cost(state)),
            rotation=_host(state.transform.rotation),
            translation=_host(state.transform.translation),
        )
        if it < iterations:
            state = method.iterate(state)


def render_registration(
    method: Method,
    source: PointCloud,
    target: PointCloud,
    guess: RigidTransform,
    out_dir: str,
    iterations: int = 20,
    every: int = 1,
    light_mode: bool = False,
    log=None,
    view_conf: dict | None = None,
) -> list[FrameDump]:
    """Step the method one iteration per frame, writing ``frame_XXXX.png``
    for every ``every``-th iteration.

    Returns the per-frame debug dumps.  ``log`` (callable) receives each
    dump as it is produced: the ``-l`` logging mode.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    # Display conf (reference ``view.conf``): window size -> figure size at
    # 100 dpi; view_scale -> fixed half-extent of the axes in scan units.
    view_conf = view_conf or {}
    figsize = (
        view_conf.get("window_width", 800) / 100.0,
        view_conf.get("window_height", 800) / 100.0,
    )
    half_extent = None
    if "view_scale" in view_conf and "window_width" in view_conf:
        # SDL mapping: pixel = view_scale * coord + displace; the visible
        # half-extent in scan units is (window/2) / view_scale.
        half_extent = (
            view_conf["window_width"] / 2.0 / view_conf["view_scale"],
            view_conf.get("window_height", view_conf["window_width"]) / 2.0
            / view_conf["view_scale"],
        )

    dumps: list[FrameDump] = []
    for state, dump in registration_frames(method, source, target, guess, iterations):
        it = dump.iteration
        if it % every == 0:
            fig, ax = plt.subplots(figsize=figsize, facecolor="white" if light_mode else "black")
            render_frame(
                ax,
                source,
                target,
                state.transform,
                getattr(state, "match_idx", None),
                getattr(state, "match_cost", None),
                light_mode=light_mode,
            )
            if half_extent is not None:
                ax.set_xlim(-half_extent[0], half_extent[0])
                ax.set_ylim(-half_extent[1], half_extent[1])
            ax.set_title(f"iteration {it}", color="black" if light_mode else "white")
            fig.savefig(os.path.join(out_dir, f"frame_{it:04d}.png"), dpi=100)
            plt.close(fig)
        dumps.append(dump)
        if log is not None:
            log(dump)
    return dumps


def render_trajectory(
    path: str,
    poses: RigidTransform,
    scans: PointCloud | None = None,
    keyframes=None,
    light_mode: bool = True,
):
    """Plot a trajectory (and optionally the world-frame map) to a PNG.

    ``poses``: batched transform ``(T, ...)``; ``scans``: optional batched
    cloud whose points are drawn in the world frame (moved on their device);
    ``keyframes``: optional indices selecting which scans to draw.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = _host(poses.translation)
    fig, ax = plt.subplots(figsize=(8, 8), facecolor="white" if light_mode else "black")
    ax.set_facecolor("white" if light_mode else "black")

    if scans is not None:
        idxs = keyframes if keyframes is not None else range(t.shape[0])
        for k in idxs:
            k = int(k)
            pose = RigidTransform(poses.rotation[k], poses.translation[k])
            pts = _valid(geometry.apply(pose, scans.points[k]), scans.count[k])
            ax.scatter(pts[:, 0], pts[:, 1], s=1, c="#8888ff", alpha=0.4, zorder=1)

    ax.plot(t[:, 0], t[:, 1], "-o", color="red", markersize=3, linewidth=1.2, zorder=3)
    ax.scatter([t[0, 0]], [t[0, 1]], marker="s", s=60, c="green", zorder=4, label="start")
    ax.scatter([t[-1, 0]], [t[-1, 1]], marker="*", s=120, c="orange", zorder=4, label="end")
    ax.legend()
    ax.set_aspect("equal")
    fig.savefig(path, dpi=110)
    plt.close(fig)


def assemble_animation(
    frame_dir: str,
    out_path: str,
    dumps: list[FrameDump] | None = None,
    fps: int = 5,
) -> str:
    """Assemble rendered ``frame_*.png`` files into a GIF or an interactive
    HTML player.

    Closes the last UX gap vs the reference's SDL viewer
    (``vis/lidar_view.cpp:37-61``): the ``.gif`` output is the passive
    animation; the ``.html`` output is a self-contained player with the SDL
    window's live controls — SPACE toggles run, I single-steps, D dumps the
    current FrameDump to the on-page console — frames and dumps embedded
    (base64), no server needed.  ``dumps`` (from
    :func:`render_registration`) overlays iteration/cost/translation on GIF
    frames and feeds the HTML D-key dump.
    """
    import base64
    import glob
    import json as _json

    fps = max(1, int(fps))  # fps<=0 would div-by-zero (GIF) / stall (HTML)
    frames = sorted(glob.glob(os.path.join(frame_dir, "frame_*.png")))
    if not frames:
        raise FileNotFoundError(f"no frame_*.png under {frame_dir}")
    by_iter = {d.iteration: d for d in dumps or []}

    def frame_iter(path):
        stem = os.path.basename(path)
        return int(stem[len("frame_"):-len(".png")])

    if out_path.endswith(".gif"):
        from PIL import Image, ImageDraw

        images = []
        for f in frames:
            im = Image.open(f).convert("RGB")
            d = by_iter.get(frame_iter(f))
            if d is not None:
                draw = ImageDraw.Draw(im)
                t = np.round(d.translation, 4).tolist()
                draw.text(
                    (8, im.height - 18),
                    f"iter {d.iteration}  cost {d.cost:.6f}  t {t}",
                    fill=(255, 215, 0),
                )
            images.append(im)
        images[0].save(
            out_path,
            save_all=True,
            append_images=images[1:],
            duration=max(1000 // fps, 20),
            loop=0,
        )
        return out_path

    if out_path.endswith(".html"):
        payload = []
        for f in frames:
            with open(f, "rb") as fh:
                b64 = base64.b64encode(fh.read()).decode("ascii")
            d = by_iter.get(frame_iter(f))
            payload.append(
                {
                    "iter": frame_iter(f),
                    "png": b64,
                    "dump": None
                    if d is None
                    else {
                        "iteration": d.iteration,
                        "cost": d.cost,
                        "rotation": d.rotation.tolist(),
                        "translation": d.translation.tolist(),
                    },
                }
            )
        html = _ANIMATION_HTML.replace("__FRAMES__", _json.dumps(payload)).replace(
            "__FPS__", str(fps)
        )
        with open(out_path, "w") as fh:
            fh.write(html)
        return out_path

    raise ValueError(f"unsupported animation format: {out_path} (use .gif or .html)")


_ANIMATION_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>icp_tpu_torch registration</title>
<style>
body { background: #111; color: #eee; font: 14px monospace; margin: 0;
       display: flex; flex-direction: column; align-items: center; }
img { max-width: 95vw; max-height: 78vh; margin-top: .6rem; }
#hud { margin: .4rem; } #console { white-space: pre; color: #8f8;
  max-height: 14vh; overflow-y: auto; width: 95vw; }
kbd { background: #333; padding: 0 .35em; border-radius: 4px; }
</style></head><body>
<div id="hud">SPACE run/pause &middot; <kbd>I</kbd> step &middot;
<kbd>D</kbd> dump &middot; frame <span id="idx">0</span></div>
<img id="view"><div id="console"></div>
<script>
const frames = __FRAMES__;
let i = 0, running = false;
const img = document.getElementById("view");
const idx = document.getElementById("idx");
const con = document.getElementById("console");
function show() { img.src = "data:image/png;base64," + frames[i].png;
                  idx.textContent = frames[i].iter; }
function step() { if (i < frames.length - 1) { i++; show(); } else running = false; }
setInterval(() => { if (running) step(); }, 1000 / __FPS__);
document.addEventListener("keydown", (e) => {
  if (e.code === "Space") { running = !running; e.preventDefault(); }
  else if (e.key === "i" || e.key === "I") { running = false; step(); }
  else if (e.key === "d" || e.key === "D") {
    con.textContent = JSON.stringify(frames[i].dump, null, 1) + "\\n" + con.textContent;
  }
});
show();
</script></body></html>
"""
