"""Per-camera 3D->2D pose refinement: Tukey-IRLS damped Levenberg-Marquardt
(the port of ``coslam_tpu/solvers/pose.py``: ``irls_pose`` and its
epipolar-augmented variant ``irls_pose_epi``).

Analytic Jacobians on the se(3) left-increment, branch-free accept/reject
by ``torch.where``; the camera axis is an explicit leading batch axis (the
JAX package vmaps a single-camera solver), so one call solves every
camera. ``irls_pose_epi`` solves one camera, with forward-mode Jacobians
(``torch.func.jacfwd``) as the JAX package takes them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slambench.reference.frozen.geometry.epipolar import fundamental_from_poses
from slambench.reference.frozen.geometry.robust import huber_weight, tukey_weight
from slambench.reference.frozen.geometry.se3 import orthonormalize_fast, se3_exp


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


def _residuals(K, R, t, X, px):
    """One camera, points first: (reprojection residuals [N, 2], Xc)."""
    Xc = X @ R.T + t
    xn = Xc[:, :2] / _safe_z(Xc[:, 2])[:, None]
    pr = torch.stack([K[0, 0] * xn[:, 0] + K[0, 2],
                      K[1, 1] * xn[:, 1] + K[1, 2]], dim=-1)
    return pr - px, Xc


def irls_pose_epi(K, R0, t0, X, px, valid3, prev_R, prev_t, px_prev,
                  valid2, tau: float = 10.0, epi_weight: float = 1.0,
                  n_irls: int = 4, n_lm: int = 8) -> IRLSPoseResult:
    """``intraCamEstimateEpi`` equivalent (SL_IntraCamPose.h:117-125) for
    one camera: the 3D->2D objective augmented with 2D-2D epipolar terms
    against the previous pose, so unmapped but tracked features still
    constrain the pose when mapped points are scarce.

    K [3, 3]; (R0, t0) the initial pose; X [N, 3], px [N, 2], valid3 [N]
    the mapped points; px_prev [N, 2] the same feature slots' pixels at the
    previous pose (prev_R, prev_t), valid2 [N] the epipolar terms. The
    Jacobians of both residuals come from forward-mode differentiation on
    the se(3) increment."""
    base3 = valid3.to(X.dtype)
    base2 = valid2.to(X.dtype) * epi_weight
    ph = torch.cat([px_prev, torch.ones_like(px_prev[:, :1])], -1)
    ch = torch.cat([px, torch.ones_like(px[:, :1])], -1)

    def residuals(xi, R, t):
        # se3_exp of a [1, 6] twist: forward-mode AD through its 0-dim
        # intermediates mixes float64 into float32 (torch 2.x)
        dR, dt = se3_exp(xi[None])
        dR, dt = dR[0], dt[0]
        Rn = dR @ R
        tn = dR @ t + dt
        r3, _ = _residuals(K, Rn, tn, X, px)
        F = fundamental_from_poses(K, prev_R, prev_t, K, Rn, tn)
        lines = ph @ F.T
        r2 = torch.sum(ch * lines, -1) / torch.clamp(
            torch.linalg.norm(lines[:, :2], dim=-1), min=1e-9)
        return r3, r2

    def weighted_cost(r3, r2, w3, w2):
        return torch.sum(w3 * torch.sum(r3 * r3, -1)) + torch.sum(w2 * r2 * r2)

    zero = torch.zeros(6, dtype=X.dtype, device=X.device)
    R, t = R0, t0
    for _ in range(n_irls):
        r3, r2 = residuals(zero, R, t)
        e3 = torch.linalg.norm(r3, dim=-1)
        e2 = torch.abs(r2)
        # Tukey on every pass, Huber only when Tukey rejects nearly all
        t3 = tukey_weight(e3, tau)
        t2 = tukey_weight(e2, tau)
        n_live = torch.sum(base3 * (t3 > 0)) + torch.sum(base2 * (t2 > 0))
        w3 = base3 * torch.where(n_live >= 6, t3, huber_weight(e3, tau))
        w2 = base2 * torch.where(n_live >= 6, t2, huber_weight(e2, tau))
        lam = torch.tensor(1e-3, dtype=X.dtype, device=X.device)
        for _ in range(n_lm):
            r3, r2 = residuals(zero, R, t)
            J3, J2 = torch.func.jacfwd(residuals)(zero, R, t)  # [N,2,6], [N,6]
            H = torch.einsum("n,nki,nkj->ij", w3, J3, J3) \
                + torch.einsum("n,ni,nj->ij", w2, J2, J2)
            g = torch.einsum("n,nki,nk->i", w3, J3, r3) \
                + torch.einsum("n,ni,n->i", w2, J2, r2)
            cost = weighted_cost(r3, r2, w3, w2)
            Hd = H + lam * torch.diag(torch.diagonal(H) + 1e-6)
            delta = -torch.linalg.solve_ex(Hd, g)[0]
            cost_new = weighted_cost(*residuals(delta, R, t), w3, w2)
            ok = (cost_new < cost) & torch.all(torch.isfinite(delta))
            dR, dt = se3_exp(torch.where(ok, delta, zero))
            R = dR @ R
            t = dR @ t + dt
            lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 5.0),
                              1e-8, 1e8)
    R = orthonormalize_fast(R)
    r3, _ = _residuals(K, R, t, X, px)
    err = torch.linalg.norm(r3, dim=-1)
    w_final = base3 * tukey_weight(err, tau)
    return IRLSPoseResult(R=R, t=t, weights=w_final, err=err,
                          cost=torch.sum(w_final * err * err))
