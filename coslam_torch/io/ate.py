"""Trajectory evaluation: Umeyama Sim(3)/SE(3) alignment + ATE (numpy; the
port's copy of ``coslam_tpu/io/ate.py``).

The metric surface for parity with the reference (BASELINE.md): absolute
trajectory error of camera centers after similarity alignment (monocular
SLAM is scale-free, so Sim(3) alignment is the standard protocol).
"""

from __future__ import annotations

import numpy as np


def camera_centers(Rs: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """[F,3,3],[F,3] world->camera -> [F,3] centers c = -R^T t."""
    return -np.einsum("fji,fj->fi", Rs, ts)


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst.
    Returns (s, R, t) with dst ~= s * R @ src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(Rs_est, ts_est, Rs_gt, ts_gt, with_scale: bool = True) -> float:
    """RMSE of aligned camera centers (meters, ground-truth scale)."""
    c_est = camera_centers(np.asarray(Rs_est), np.asarray(ts_est))
    c_gt = camera_centers(np.asarray(Rs_gt), np.asarray(ts_gt))
    s, R, t = umeyama(c_est, c_gt, with_scale)
    aligned = (s * (R @ c_est.T)).T + t
    return float(np.sqrt(((aligned - c_gt) ** 2).sum(-1).mean()))
