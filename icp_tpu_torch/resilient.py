"""Elastic restart: checkpointed odometry and SLAM, and a bounded-retry
supervisor.

Port of :mod:`icp_tpu.resilient`.  Long-running streams over an unbounded
scan log must survive a kill anywhere:

* :class:`CheckpointManager` — atomic (tmp + ``os.replace``), rotating
  (keep-K) ``ckpt_<step>.npz`` checkpoints of a dict of arrays; an
  unreadable newest file falls back a generation.  The files are the JAX
  package's: a run of either package resumes from the other's.
* :func:`resumable_stream_odometry` — keyframe stream odometry
  (:func:`icp_tpu_torch.odometry.stream_step`) with periodic checkpoints of
  its whole state; a restart fast-forwards and continues exactly.
* :func:`resumable_online_slam` — the same for
  :class:`icp_tpu_torch.slam.OnlineSlam`.
* :func:`run_with_retries` — re-invokes a job on an exception, at most
  ``max_restarts`` times.
"""

from __future__ import annotations

import json
import os
import time
import warnings

import numpy as np
import torch

from . import geometry
from .cloud import PointCloud

__all__ = [
    "CheckpointManager",
    "resumable_stream_odometry",
    "resumable_online_slam",
    "run_with_retries",
    "job_status",
    "format_status",
]


class CheckpointManager:
    """Atomic rotating checkpoints of ``(step, arrays dict)`` on disk.

    Files are ``ckpt_<step>.npz`` written via tmp + ``os.replace`` (a reader
    never sees a half-written file); the ``keep`` newest are retained.
    :meth:`latest` skips unreadable files, so a crash during a save degrades
    to the previous generation.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:09d}.npz")

    def _steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_") and name.endswith(".npz"):
                try:
                    out.append(int(name[5:-4]))
                except ValueError:
                    continue
        return sorted(out)

    def save(self, step: int, arrays: dict) -> str:
        """Atomically persist ``arrays`` (str -> array or tensor) as ``step``."""
        path = self._path(step)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **{k: _numpy(v) for k, v in arrays.items()})
        os.replace(tmp, path)
        for old in self._steps()[: -self.keep]:
            try:
                os.remove(self._path(old))
            except OSError:
                pass
        return path

    def latest(self) -> tuple[int, dict] | None:
        """The newest readable checkpoint as ``(step, arrays)``, or None."""
        for step in reversed(self._steps()):
            path = self._path(step)
            try:
                with np.load(path) as data:
                    return step, {k: data[k] for k in data.files}
            except Exception as e:  # noqa: BLE001 - fall back a generation
                warnings.warn(f"icp_tpu_torch.resilient: skipping unreadable {path}: {e}")
        return None


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pack_state(t, keyframe, kf_pose, pose, poses_so_far, dim):
    return {
        "t": np.asarray(t),
        "dim": np.asarray(dim),
        "kf_points": _numpy(keyframe.points),
        "kf_count": _numpy(keyframe.count),
        "kf_rot": _numpy(kf_pose.rotation),
        "kf_trans": _numpy(kf_pose.translation),
        "rot": _numpy(pose.rotation),
        "trans": _numpy(pose.translation),
        "traj_rot": np.stack([_numpy(p.rotation) for p in poses_so_far]),
        "traj_trans": np.stack([_numpy(p.translation) for p in poses_so_far]),
    }


def resumable_stream_odometry(
    scans,
    method,
    config,
    checkpoint_dir: str,
    checkpoint_every: int = 10,
    translation_threshold: float = 0.5,
    angle_threshold: float = 0.1,
    metrics=None,
    device="cuda",
):
    """Streaming keyframe odometry with crash-resume.

    ``scans`` is an indexable sequence of clouds on ``device`` (resume needs
    random access); a restored state lands there too.  Yields ``(t, pose,
    is_keyframe, result)`` for every scan this process handles: scans
    already checkpointed are skipped.  The whole state is checkpointed
    every ``checkpoint_every`` scans and at the stream's end; the resumed
    trajectory is bit-identical to an uninterrupted run.
    """
    from .driver import make_converge_fn
    from .odometry import stream_step

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("resumable_stream_odometry: device 'cuda' needs a CUDA card "
                           "(pass device='cpu' to run on the host)")
    manager = CheckpointManager(checkpoint_dir)
    fn = make_converge_fn(method, config)

    def tensor(x):
        return torch.as_tensor(np.asarray(x), device=device)

    start_t = 0
    keyframe = None
    kf_pose = pose = None
    poses_so_far: list[geometry.RigidTransform] = []
    loaded = manager.latest()
    if loaded is not None:
        _, s = loaded
        start_t = int(s["t"]) + 1
        keyframe = PointCloud(tensor(s["kf_points"]), tensor(s["kf_count"]).to(torch.int32))
        kf_pose = geometry.RigidTransform(tensor(s["kf_rot"]), tensor(s["kf_trans"]))
        pose = geometry.RigidTransform(tensor(s["rot"]), tensor(s["trans"]))
        poses_so_far = [geometry.RigidTransform(tensor(s["traj_rot"][i]),
                                                tensor(s["traj_trans"][i]))
                        for i in range(s["traj_rot"].shape[0])]

    for t in range(start_t, len(scans)):
        scan = scans[t]
        if keyframe is None:
            dim = scan.dim
            keyframe = scan
            kf_pose = geometry.identity(dim, dtype=scan.dtype, device=scan.points.device)
            pose = kf_pose
            poses_so_far.append(pose)
            manager.save(t, _pack_state(t, keyframe, kf_pose, pose, poses_so_far, dim))
            yield t, pose, True, None
            continue
        pose, is_kf, result = stream_step(
            fn, keyframe, kf_pose, scan, translation_threshold, angle_threshold)
        if is_kf:
            keyframe = scan
            kf_pose = pose
        poses_so_far.append(pose)
        if metrics is not None:
            metrics.log("odometry_step", scan=t, iterations=int(result.iteration_count),
                        cost=float(result.cost), keyframe=is_kf)
        if (t - start_t) % checkpoint_every == checkpoint_every - 1 or t == len(scans) - 1:
            manager.save(t, _pack_state(t, keyframe, kf_pose, pose, poses_so_far, scan.dim))
        yield t, pose, is_kf, result


def run_with_retries(
    job,
    max_restarts: int = 3,
    retry_on: tuple[type[BaseException], ...] = (Exception,),
    backoff_s: float = 0.0,
    on_restart=None,
):
    """Call ``job()``; on a ``retry_on`` exception call it again, at most
    ``max_restarts`` times (the job resumes from its own checkpoints).
    Returns the successful call's result; re-raises once the budget is
    spent.  ``on_restart(attempt, exc)`` runs before each retry."""
    attempt = 0
    while True:
        try:
            return job()
        except retry_on as e:  # noqa: PERF203 - supervisor loop
            attempt += 1
            if attempt > max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
            if backoff_s:
                time.sleep(backoff_s * attempt)


def job_status(checkpoint_dir: str) -> dict:
    """The progress of a (possibly dead) resumable odometry run."""
    loaded = CheckpointManager(checkpoint_dir).latest()
    if loaded is None:
        return {"checkpointed": False}
    _, s = loaded
    return {
        "checkpointed": True,
        "last_scan": int(s["t"]),
        "trajectory_length": int(s["traj_rot"].shape[0]),
        "position": [float(x) for x in s["trans"]],
    }


def _json_default(o):
    return o.tolist() if isinstance(o, np.ndarray) else str(o)


def format_status(checkpoint_dir: str) -> str:
    return json.dumps(job_status(checkpoint_dir), default=_json_default)


def resumable_online_slam(
    scans,
    method,
    config,
    manager: CheckpointManager,
    checkpoint_every: int = 5,
    device="cuda",
    **online_kwargs,
):
    """Crash-resumable :class:`icp_tpu_torch.slam.OnlineSlam` on ``device``:
    yields ``(scan_index, online, update)`` per scan, checkpointing the full
    streaming state every ``checkpoint_every`` scans.  A restart
    fast-forwards to the first unprocessed scan; the resumed keyframe
    trajectory is bit-identical to an uninterrupted run.  Call
    ``online.finalize()`` when the iterable is exhausted."""
    from .slam import OnlineSlam

    online = OnlineSlam(method, config, device=device, **online_kwargs)
    start = 0
    latest = manager.latest()
    if latest is not None:
        step, state = latest
        online.load_state(state)
        start = step
    for t, scan in enumerate(scans):
        if t < start:
            continue  # fast-forward past checkpointed work
        update = online.add_scan(scan)
        if (t + 1) % checkpoint_every == 0:
            manager.save(t + 1, online.state_dict())
        yield t, online, update
