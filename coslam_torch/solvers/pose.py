"""Per-camera 3D->2D pose refinement: Tukey-IRLS damped Levenberg-Marquardt
(the port of ``coslam_tpu/solvers/pose.py::irls_pose``).

Analytic Jacobians on the se(3) left-increment, branch-free accept/reject
by ``torch.where``; the camera axis is an explicit leading batch axis (the
JAX package vmaps a single-camera solver), so one call solves every
camera.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coslam_torch.geometry.robust import huber_weight, tukey_weight
from coslam_torch.geometry.se3 import orthonormalize_fast, se3_exp


class IRLSPoseResult(NamedTuple):
    R: torch.Tensor        # [..., 3, 3]
    t: torch.Tensor        # [..., 3]
    weights: torch.Tensor  # [..., N] final IRLS weights (0 for outliers)
    err: torch.Tensor      # [..., N] final per-point reprojection error (px)
    cost: torch.Tensor     # [...] final weighted cost


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def _residuals_ln(K, R, t, XT, pxT):
    """Batched over B cameras. XT: [B, 3, N]; pxT: [B, 2, N].
    Returns (ru, rv [B, N], Xc [B, 3, N])."""
    Xc = R @ XT + t[..., None]
    zs = _safe_z(Xc[:, 2])
    fx, fy = K[:, 0, 0, None], K[:, 1, 1, None]
    cx, cy = K[:, 0, 2, None], K[:, 1, 2, None]
    ru = fx * Xc[:, 0] / zs + cx - pxT[:, 0]
    rv = fy * Xc[:, 1] / zs + cy - pxT[:, 1]
    return ru, rv, Xc


def _jacobian_ln(K, Xc):
    """Rows of the 2x6 left-increment Jacobian, points last: (Ju, Jv), each
    [B, 6, N], columns ordered (w1, w2, w3, v1, v2, v3)."""
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    zi = 1.0 / _safe_z(z)
    fx, fy = K[:, 0, 0, None], K[:, 1, 1, None]
    xz = x * zi
    yz = y * zi
    zero = torch.zeros_like(x)
    Ju = torch.stack([-fx * xz * yz, fx * (1.0 + xz * xz), -fx * yz,
                      fx * zi, zero, -fx * xz * zi], dim=1)
    Jv = torch.stack([-fy * (1.0 + yz * yz), fy * xz * yz, fy * xz,
                      zero, fy * zi, -fy * yz * zi], dim=1)
    return Ju, Jv


def _chol_solve6(A, b):
    """Solve the SPD 6x6 systems A x = b ([B, 6, 6], [B, 6]) by unrolled
    Cholesky with the pivot floored at 1e-20, as the JAX solver does."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[:, j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=1e-20))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = b[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def irls_pose(K, R0, t0, X, px, valid, tau=10.0, n_irls: int = 5,
              n_lm: int = 10, point_weight=None) -> IRLSPoseResult:
    """Robust pose refinement of one camera or of a batch of cameras.

    K: [..., 3, 3]; R0, t0: initial pose; X: [..., N, 3] world points; px:
    [..., N, 2] undistorted pixel observations; valid: [..., N] mask;
    ``point_weight`` optionally scales each point's influence. Leading
    axes (none, or one camera axis) are batched."""
    single = K.dim() == 2
    if single:
        K, R0, t0, X, px, valid = (a[None] for a in (K, R0, t0, X, px,
                                                     valid))
        if point_weight is not None:
            point_weight = point_weight[None]
    base_w = valid.to(X.dtype)
    if point_weight is not None:
        base_w = base_w * point_weight
    XT = X.transpose(1, 2)          # [B, 3, N]
    pxT = px.transpose(1, 2)        # [B, 2, N]
    R, t, w = R0, t0, base_w
    for _ in range(n_irls):
        ru, rv, _ = _residuals_ln(K, R, t, XT, pxT)
        en = torch.sqrt(ru * ru + rv * rv)
        # Tukey on every pass (Huber only when Tukey rejects nearly all)
        w_tuk = tukey_weight(en, tau)
        n_live = torch.sum(base_w * (w_tuk > 0), dim=-1, keepdim=True)
        w_rob = torch.where(n_live >= 6, w_tuk, huber_weight(en, tau))
        w = base_w * w_rob
        lam = torch.full((K.shape[0],), 1e-3, dtype=X.dtype, device=X.device)
        for _ in range(n_lm):
            ru, rv, Xc = _residuals_ln(K, R, t, XT, pxT)
            we = torch.where(Xc[:, 2] <= 1e-6, torch.zeros_like(w), w)
            Ju, Jv = _jacobian_ln(K, Xc)
            Juw = Ju * we[:, None, :]
            Jvw = Jv * we[:, None, :]
            H = Juw @ Ju.transpose(1, 2) + Jvw @ Jv.transpose(1, 2)
            g = (Juw @ ru[..., None] + Jvw @ rv[..., None])[..., 0]
            cost = torch.sum(we * (ru * ru + rv * rv), dim=-1)
            Hd = H + lam[:, None, None] * torch.diag_embed(
                torch.diagonal(H, dim1=-2, dim2=-1) + 1e-6)
            delta = -_chol_solve6(Hd, g)
            dR, dt = se3_exp(delta)
            R_new = dR @ R
            t_new = torch.einsum("bij,bj->bi", dR, t) + dt
            ru_n, rv_n, Xc_new = _residuals_ln(K, R_new, t_new, XT, pxT)
            we_new = torch.where(Xc_new[:, 2] <= 1e-6, torch.zeros_like(w),
                                 w)
            cost_new = torch.sum(we_new * (ru_n * ru_n + rv_n * rv_n),
                                 dim=-1)
            ok = (cost_new < cost) & torch.all(torch.isfinite(delta), dim=-1)
            R = torch.where(ok[:, None, None], R_new, R)
            t = torch.where(ok[:, None], t_new, t)
            lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 5.0),
                              1e-8, 1e8)
    R = orthonormalize_fast(R)
    ru, rv, Xc = _residuals_ln(K, R, t, XT, pxT)
    err = torch.sqrt(ru * ru + rv * rv)
    w_final = base_w * tukey_weight(err, tau) * (Xc[:, 2] > 1e-6)
    cost = torch.sum(w_final * (ru * ru + rv * rv), dim=-1)
    out = IRLSPoseResult(R=R, t=t, weights=w_final, err=err, cost=cost)
    if single:
        out = IRLSPoseResult(*(a[0] for a in out))
    return out
