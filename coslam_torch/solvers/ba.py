"""Windowed robust bundle adjustment over a dense [S, P] observation table
(the port of the table form of ``coslam_tpu/solvers/ba.py``).

Each point is observed at most once per (keyframe, camera) slot, so the
observations form a dense [S, P] table. Camera blocks reduce over the
point axis, point blocks over the slot axis, landmark 3x3 blocks are
inverted in closed form and the Schur complement is one [6S, 3P] x
[3P, 6S] matrix product; the reduced [6S, 6S] camera system is solved
densely. Robust protocol: Huber outer passes, Tukey on the last, outlier
out-flags (bundleAdjustRobust). The first cameras of the window may be
frozen (gauge) and points may be frozen (pre-window anchors).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coslam_torch.geometry.robust import huber_weight, tukey_weight
from coslam_torch.geometry.se3 import orthonormalize_fast, se3_exp
from coslam_torch.geometry.triangulate import inv3x3_sym_ln


class BATableProblem(NamedTuple):
    K: torch.Tensor           # [S, 3, 3]
    R: torch.Tensor           # [S, 3, 3] initial
    t: torch.Tensor           # [S, 3]
    X: torch.Tensor           # [P, 3] initial
    obs_px: torch.Tensor      # [S, 2, P] undistorted pixels
    obs_valid: torch.Tensor   # [S, P]
    cam_fixed: torch.Tensor   # [S]
    point_fixed: torch.Tensor  # [P]


class BATableResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    obs_outlier: torch.Tensor   # [S, P]
    obs_err: torch.Tensor       # [S, P]
    cost: torch.Tensor
    obs_valid: torch.Tensor     # [S, P] problem mask passthrough


def _camera_coords(R, t, X):
    """R [S,3,3], t [S,3], X [3,P] -> Xc [3, S, P]."""
    return torch.einsum("sij,jp->isp", R, X) + t.T[:, :, None]


def _residuals(K, R, t, X, obs_px):
    Xc = _camera_coords(R, t, X)
    z = Xc[2]
    zi = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    ru = K[:, 0, 0, None] * Xc[0] * zi + K[:, 0, 2, None] - obs_px[:, 0]
    rv = K[:, 1, 1, None] * Xc[1] * zi + K[:, 1, 2, None] - obs_px[:, 1]
    return ru, rv, z, Xc, zi


def _table_terms(K, R, t, X, obs_px, w):
    """Normal-equation blocks. X: [3, P]; w: [S, P]. Returns (Hcc [S,6,6],
    gc [S,6], Wcp [6,3,S,P], Hpp [3,3,P], gp [3,P], cost)."""
    ru, rv, z, Xc, zi = _residuals(K, R, t, X, obs_px)
    fx, fy = K[:, 0, 0, None], K[:, 1, 1, None]
    xz = Xc[0] * zi
    yz = Xc[1] * zi
    zero = torch.zeros_like(z)
    Ju6 = torch.stack([-fx * xz * yz, fx * (1.0 + xz * xz), -fx * yz,
                       fx * zi, zero, -fx * xz * zi])          # [6, S, P]
    Jv6 = torch.stack([-fy * (1.0 + yz * yz), fy * xz * yz, fy * xz,
                       zero, fy * zi, -fy * yz * zi])
    # point Jacobian rows: d(px)/dX = Jpx @ R
    Jup = fx * (R[:, 0, :].T[:, :, None] - xz * R[:, 2, :].T[:, :, None]) * zi
    Jvp = fy * (R[:, 1, :].T[:, :, None] - yz * R[:, 2, :].T[:, :, None]) * zi
    ws = torch.where(z <= 1e-6, torch.zeros_like(w), w)
    # zero dead entries' Jacobians BEFORE any product: a z ~ 0 column has
    # entries ~ fx/z^2 whose products overflow f32, and 0 * inf = NaN
    live = ws > 0
    Ju6, Jv6, Jup, Jvp = (torch.where(live, a, torch.zeros_like(a))
                          for a in (Ju6, Jv6, Jup, Jvp))
    Juw, Jvw = Ju6 * ws, Jv6 * ws
    Hcc = torch.einsum("isp,jsp->sij", Juw, Ju6) \
        + torch.einsum("isp,jsp->sij", Jvw, Jv6)
    gc = torch.einsum("isp,sp->si", Juw, ru) + torch.einsum("isp,sp->si",
                                                            Jvw, rv)
    Wcp = Juw[:, None] * Jup[None] + Jvw[:, None] * Jvp[None]  # [6,3,S,P]
    Hpp = torch.einsum("isp,jsp->ijp", Jup * ws, Jup) \
        + torch.einsum("isp,jsp->ijp", Jvp * ws, Jvp)
    Hpp = Hpp + 1e-9 * torch.eye(3, dtype=Hpp.dtype,
                                 device=Hpp.device)[:, :, None]
    gp = torch.einsum("isp,sp->ip", Jup * ws, ru) \
        + torch.einsum("isp,sp->ip", Jvp * ws, rv)
    cost = torch.sum(ws * (ru * ru + rv * rv))
    return Hcc, gc, Wcp, Hpp, gp, cost


def _table_schur(Hcc, gc, Wcp, Hpp, gp, lam, cam_fixed, point_fixed):
    """Damped GN step: eliminate points (closed-form 3x3), solve the
    reduced [6S, 6S] camera system, back-substitute."""
    S = Hcc.shape[0]
    P = gp.shape[1]
    dt, dev = Hcc.dtype, Hcc.device
    eye3 = torch.eye(3, dtype=dt, device=dev)[:, :, None]
    pf = point_fixed
    Hpp_d = Hpp * (1.0 + lam * eye3) + lam * 1e-3 * eye3
    Hpp_d = torch.where(pf, eye3.expand(3, 3, P), Hpp_d)
    Hinv = torch.stack([torch.stack(r) for r in inv3x3_sym_ln(
        [[Hpp_d[i, j] for j in range(3)] for i in range(3)])])  # [3,3,P]
    zero = torch.zeros((), dtype=dt, device=dev)
    gp_m = torch.where(pf, zero, gp)
    Wm = torch.where(pf, zero, Wcp)                            # [6,3,S,P]
    Y = torch.einsum("ilsp,lkp->iksp", Wm, Hinv)
    Ymat = Y.permute(2, 0, 1, 3).reshape(S * 6, 3 * P)
    Wmat = Wm.permute(2, 0, 1, 3).reshape(S * 6, 3 * P)
    Sred = -(Ymat @ Wmat.T)
    Ygp = (Ymat @ gp_m.reshape(3 * P)).reshape(S, 6)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    Hcc_d = Hcc + lam * (eye6 * 1e-3 + Hcc * eye6)
    Sred = Sred.reshape(S, 6, S, 6)
    ar = torch.arange(S, device=dev)
    Sred[ar, :, ar, :] += Hcc_d
    rhs = gc - Ygp
    free = (~cam_fixed).to(dt)
    Sred = Sred * free[:, None, None, None] * free[None, None, :, None]
    Sred[ar, :, ar, :] += eye6[None] * cam_fixed[:, None, None].to(dt)
    rhs = rhs * free[:, None]
    dc = -torch.linalg.solve(Sred.reshape(S * 6, S * 6),
                             rhs.reshape(-1)).reshape(S, 6)
    Wt_dc = torch.einsum("iksp,si->kp", Wm, dc)
    dX = -torch.einsum("klp,lp->kp", Hinv, gp_m + Wt_dc)
    return dc, dX


def bundle_adjust_table(prob: BATableProblem, max_err: float = 10.0,
                        max_iter: int = 2,
                        inner_iter: int = 10) -> BATableResult:
    """Robust windowed BA over the dense [S, P] observation table."""
    dt = prob.X.dtype
    base_w = prob.obs_valid.to(dt)                        # [S, P]
    R, t, X = prob.R, prob.t, prob.X.T.contiguous()       # X: [3, P]
    w = base_w
    zero = torch.zeros((), dtype=dt, device=X.device)
    for k in range(max_iter):
        ru, rv, z, _, _ = _residuals(prob.K, R, t, X, prob.obs_px)
        en = torch.hypot(ru, rv)
        w_rob = huber_weight(en, max_err) if k < max_iter - 1 else \
            tukey_weight(en, max_err)
        w = base_w * w_rob * (z > 1e-6)
        lam = torch.full((), 1e-4, dtype=dt, device=X.device)
        for _ in range(inner_iter):
            Hcc, gc, Wcp, Hpp, gp, cost = _table_terms(
                prob.K, R, t, X, prob.obs_px, w)
            dc, dX = _table_schur(Hcc, gc, Wcp, Hpp, gp, lam,
                                  prob.cam_fixed, prob.point_fixed)
            finite = torch.all(torch.isfinite(dc)) & \
                torch.all(torch.isfinite(dX))
            dc = torch.where(finite & ~prob.cam_fixed[:, None], dc, zero)
            dX = torch.where(prob.point_fixed | ~finite, zero, dX)
            dRs, dts = se3_exp(dc)
            R_new = dRs @ R
            t_new = torch.einsum("mij,mj->mi", dRs, t) + dts
            X_new = X + dX
            ru2, rv2, z2, _, _ = _residuals(prob.K, R_new, t_new, X_new,
                                            prob.obs_px)
            w2 = torch.where(z2 <= 1e-6, zero, w)
            cost_new = torch.sum(w2 * (ru2 * ru2 + rv2 * rv2))
            ok = (cost_new < cost) & finite
            R = torch.where(ok, R_new, R)
            t = torch.where(ok, t_new, t)
            X = torch.where(ok, X_new, X)
            lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 8.0),
                              1e-8, 1e8)
    R = orthonormalize_fast(R)
    ru, rv, z, _, _ = _residuals(prob.K, R, t, X, prob.obs_px)
    err = torch.hypot(ru, rv)
    outlier = prob.obs_valid & ((err > max_err) | (z <= 1e-6))
    w_fin = base_w * tukey_weight(err, max_err) * (z > 1e-6)
    cost = torch.sum(w_fin * (ru * ru + rv * rv))
    return BATableResult(R=R, t=t, X=X.T.contiguous(), obs_outlier=outlier,
                         obs_err=err, cost=cost, obs_valid=prob.obs_valid)
