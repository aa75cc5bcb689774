"""Trajectory evaluation: ATE and RPE in the TUM protocol.

Port of :mod:`icp_tpu.eval` (host numpy in float64, the same arithmetic).
Estimated and ground-truth trajectories compare through the two standard
metrics (Sturm et al., "A Benchmark for the Evaluation of RGB-D SLAM
Systems", IROS 2012):

* **ATE** (absolute trajectory error): the estimate is aligned onto the
  ground truth by the closed-form least-squares SE(D) fit (Umeyama 1991),
  then the per-pose translation errors are summarized.  It measures global
  consistency.
* **RPE** (relative pose error): the per-step error of the relative motion
  over a fixed frame delta, free of any alignment.  It measures local drift.

Inputs are batched :class:`icp_tpu_torch.geometry.RigidTransform` poses on
any device (copied to the host) or plain ``(T, D)`` arrays of translations.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "umeyama_alignment",
    "ate",
    "rpe",
    "AteResult",
    "RpeResult",
]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def _translations(poses) -> np.ndarray:
    t = _host(getattr(poses, "translation", poses))
    if t.ndim != 2:
        raise ValueError(f"expected (T, D) translations, got shape {t.shape}")
    return t


def _rotations(poses) -> np.ndarray | None:
    r = getattr(poses, "rotation", None)
    return None if r is None else _host(r)


def umeyama_alignment(
    source: np.ndarray, target: np.ndarray, with_scale: bool = False
) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity fit ``target ~ s·R @ source + t``.

    Closed form (Umeyama 1991, Theorem): SVD of the cross-covariance with
    the determinant-sign correction, so the returned ``R`` is always a
    proper rotation even for reflective point configurations.  With
    ``with_scale=False`` (the SE(D) fit used by ATE) ``s`` is returned as
    exactly 1.0.  Works for D=2 and D=3.
    """
    src = np.asarray(source, dtype=np.float64)
    tgt = np.asarray(target, dtype=np.float64)
    if src.shape != tgt.shape:
        raise ValueError(f"shape mismatch: {src.shape} vs {tgt.shape}")
    t_total, dim = src.shape
    mu_s = src.mean(axis=0)
    mu_t = tgt.mean(axis=0)
    ds = src - mu_s
    dt = tgt - mu_t
    cov = dt.T @ ds / t_total
    u, sv, vt = np.linalg.svd(cov)
    sign = np.ones(dim)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        sign[-1] = -1.0
    rot = u @ np.diag(sign) @ vt
    if with_scale:
        var_s = (ds * ds).sum() / t_total
        scale = float((sv * sign).sum() / var_s) if var_s > 0 else 1.0
    else:
        scale = 1.0
    trans = mu_t - scale * rot @ mu_s
    return rot, trans, scale


@dataclasses.dataclass(frozen=True)
class AteResult:
    """Per-pose absolute translation errors + the alignment that produced
    them.  ``rmse`` is the headline number of the TUM protocol."""

    rmse: float
    mean: float
    median: float
    max: float
    errors: np.ndarray  # (T,) per-pose translation error
    rotation: np.ndarray  # (D, D) alignment applied to the estimate
    translation: np.ndarray  # (D,)
    scale: float

    def as_dict(self) -> dict:
        return {
            "ate_rmse": self.rmse,
            "ate_mean": self.mean,
            "ate_median": self.median,
            "ate_max": self.max,
        }


def ate(estimate, ground_truth, align: str = "umeyama") -> AteResult:
    """Absolute trajectory error of ``estimate`` against ``ground_truth``.

    ``align`` selects the gauge:

    * ``'umeyama'`` (default, the TUM protocol): closed-form least-squares
      SE(D) alignment of the estimated onto the true translations before
      differencing — the estimate's arbitrary start frame cannot charge
      error.
    * ``'sim'``: Umeyama WITH scale (monocular-style evaluation).
    * ``'first'``: express both trajectories relative to their first pose
      (requires rotations); the gauge this framework's odometry already
      uses (scan-0 frame), so errors read directly as end-drift.
    * ``'none'``: compare raw translations.
    """
    est = _translations(estimate)
    gt = _translations(ground_truth)
    if est.shape != gt.shape:
        raise ValueError(f"trajectory shape mismatch: {est.shape} vs {gt.shape}")
    dim = est.shape[1]
    if align in ("umeyama", "sim"):
        rot, trans, scale = umeyama_alignment(est, gt, with_scale=(align == "sim"))
    elif align == "first":
        r_e, r_g = _rotations(estimate), _rotations(ground_truth)
        if r_e is None or r_g is None:
            raise ValueError("align='first' needs rotations on both inputs")
        # gt_0^-1 ∘ gt  vs  est_0^-1 ∘ est: fold both start frames into one
        # alignment applied to the estimate: g = R0g^T(x - t0g) applied to
        # gt, inverse-composed — equivalently align est by
        # R = R0g R0e^T, t = t0g - R t0e.
        rot = r_g[0] @ r_e[0].T
        trans = gt[0] - rot @ est[0]
        scale = 1.0
    elif align == "none":
        rot = np.eye(dim)
        trans = np.zeros(dim)
        scale = 1.0
    else:
        raise ValueError(
            f"unknown align {align!r}; one of 'umeyama', 'sim', 'first', 'none'"
        )
    aligned = scale * est @ rot.T + trans
    errors = np.linalg.norm(aligned - gt, axis=-1)
    return AteResult(
        rmse=float(np.sqrt(np.mean(errors**2))),
        mean=float(errors.mean()),
        median=float(np.median(errors)),
        max=float(errors.max()),
        errors=errors,
        rotation=rot,
        translation=trans,
        scale=scale,
    )


@dataclasses.dataclass(frozen=True)
class RpeResult:
    """Relative pose error over a fixed frame delta."""

    trans_rmse: float
    trans_mean: float
    trans_max: float
    rot_rmse_rad: float
    rot_mean_rad: float
    rot_max_rad: float
    delta: int
    trans_errors: np.ndarray  # (T - delta,)
    rot_errors: np.ndarray  # (T - delta,) radians

    def as_dict(self) -> dict:
        return {
            "rpe_trans_rmse": self.trans_rmse,
            "rpe_trans_mean": self.trans_mean,
            "rpe_rot_rmse_deg": float(np.degrees(self.rot_rmse_rad)),
            "rpe_rot_mean_deg": float(np.degrees(self.rot_mean_rad)),
            "rpe_delta": self.delta,
        }


def _rotation_angle(r: np.ndarray) -> np.ndarray:
    """Batched rotation angle of (..., D, D) rotation matrices, D in 2/3."""
    dim = r.shape[-1]
    if dim == 2:
        return np.abs(np.arctan2(r[..., 1, 0], r[..., 0, 0]))
    tr = np.clip((np.trace(r, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    return np.arccos(tr)


def rpe(estimate, ground_truth, delta: int = 1) -> RpeResult:
    """Relative pose error over frame pairs ``(k, k + delta)``.

    Gauge-free: only relative motions enter, so no alignment is applied
    (the TUM protocol's fixed-delta variant; ``delta=1`` measures per-step
    odometry drift).  Needs rotations on both trajectories.
    """
    est_t, gt_t = _translations(estimate), _translations(ground_truth)
    est_r, gt_r = _rotations(estimate), _rotations(ground_truth)
    if est_r is None or gt_r is None:
        raise ValueError("rpe needs rotations on both trajectories")
    t_total = est_t.shape[0]
    if not (0 < delta < t_total):
        raise ValueError(f"delta must be in (0, {t_total}), got {delta}")
    a, b = slice(0, t_total - delta), slice(delta, t_total)

    # Relative motion k -> k+delta in frame k: R_k^T (x_{k+d} - x_k).
    def relative(r, t):
        dr = np.einsum("tji,tjk->tik", r[a], r[b])  # R_k^T R_{k+d}
        dt = np.einsum("tji,tj->ti", r[a], t[b] - t[a])
        return dr, dt

    er, et = relative(est_r, est_t)
    gr, gt_rel = relative(gt_r, gt_t)
    # Error motion: (gt_rel)^-1 ∘ est_rel.
    err_r = np.einsum("tji,tjk->tik", gr, er)
    err_t = np.einsum("tji,tj->ti", gr, et - gt_rel)
    trans_errors = np.linalg.norm(err_t, axis=-1)
    rot_errors = _rotation_angle(err_r)
    return RpeResult(
        trans_rmse=float(np.sqrt(np.mean(trans_errors**2))),
        trans_mean=float(trans_errors.mean()),
        trans_max=float(trans_errors.max()),
        rot_rmse_rad=float(np.sqrt(np.mean(rot_errors**2))),
        rot_mean_rad=float(rot_errors.mean()),
        rot_max_rad=float(rot_errors.max()),
        delta=delta,
        trans_errors=trans_errors,
        rot_errors=rot_errors,
    )
