"""Robust bundle adjustment (the port of ``coslam_tpu/solvers/ba.py``), in
two forms.

- The dense table (``bundle_adjust_table``, windowed BA): each point is
  observed at most once per (keyframe, camera) slot, so the observations
  form a dense [S, P] table. Camera blocks reduce over the point axis,
  point blocks over the slot axis, landmark 3x3 blocks are inverted in
  closed form and the Schur complement is one [6S, 3P] x [3P, 6S] matrix
  product.
- The observation list (``bundle_adjust``: the multi-camera map init and
  the joint multi-camera pose): per-observation 2x6 / 2x3 Jacobian
  blocks, accumulated onto cameras and points with ``index_add_`` (the
  JAX package's segment sums).

Both solve the reduced camera system densely. Robust protocol: Huber
outer passes, Tukey on the last, outlier out-flags (bundleAdjustRobust).
Cameras may be frozen (gauge) and points may be frozen (anchors).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coslam_torch.geometry.robust import huber_weight, tukey_weight
from coslam_torch.geometry.se3 import orthonormalize_fast, se3_exp, so3_hat
from coslam_torch.geometry.triangulate import inv3x3_sym, inv3x3_sym_ln


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
    # solve_ex: no host sync for the error check (a singular system gives
    # non-finite steps, which the caller rejects)
    dc = -torch.linalg.solve_ex(Sred.reshape(S * 6, S * 6),
                                rhs.reshape(-1))[0].reshape(S, 6)
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


# ---------------------------------------------------------------------------
# observation-list form
# ---------------------------------------------------------------------------

class BAProblem(NamedTuple):
    """M cameras, P points, O observation slots (``obs_valid`` masks)."""

    K: torch.Tensor           # [M, 3, 3]
    R: torch.Tensor           # [M, 3, 3] initial
    t: torch.Tensor           # [M, 3]
    X: torch.Tensor           # [P, 3] initial
    obs_cam: torch.Tensor     # [O] int camera index
    obs_pt: torch.Tensor      # [O] int point index
    obs_px: torch.Tensor      # [O, 2] undistorted pixel measurements
    obs_valid: torch.Tensor   # [O] bool
    cam_fixed: torch.Tensor   # [M] bool
    point_fixed: torch.Tensor  # [P] bool


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    obs_outlier: torch.Tensor   # [O] bool, the Meas2D.outlier out-flags
    obs_err: torch.Tensor       # [O] final reprojection error (px)
    cost: torch.Tensor


def _project_res(K, R, t, X, obs_cam, obs_pt, obs_px):
    Rm, tm, Km, Xo = R[obs_cam], t[obs_cam], K[obs_cam], X[obs_pt]
    Xc = torch.einsum("oij,oj->oi", Rm, Xo) + tm
    z = Xc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    pr = torch.stack([Km[:, 0, 0] * Xc[:, 0] / zs + Km[:, 0, 2],
                      Km[:, 1, 1] * Xc[:, 1] / zs + Km[:, 1, 2]], dim=-1)
    return pr - obs_px, Xc, Rm, Km


def _obs_jacobians(Km, Rm, Xc):
    """(Jc [O, 2, 6] wrt the camera's left increment, Jp [O, 2, 3] wrt the
    point)."""
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    zi = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    fx, fy = Km[:, 0, 0], Km[:, 1, 1]
    zero = torch.zeros_like(x)
    du = torch.stack([fx * zi, zero, -fx * x * zi * zi], dim=-1)
    dv = torch.stack([zero, fy * zi, -fy * y * zi * zi], dim=-1)
    Jpx = torch.stack([du, dv], dim=-2)                    # [O, 2, 3]
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(
        Xc.shape[0], 3, 3)
    dXc_dxi = torch.cat([-so3_hat(Xc), eye], dim=-1)       # [O, 3, 6]
    return Jpx @ dXc_dxi, Jpx @ Rm


def _segment_sum(vals, seg, n):
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, seg, vals)


def _ba_normal_terms(K, R, t, X, prob: BAProblem, w):
    """(Hcc [M,6,6], Wcp [P,M,6,3], Hpp [P,3,3], gc [M,6], gp [P,3], cost)
    at the current estimate; ``w`` are per-observation robust weights."""
    M, P = prob.K.shape[0], prob.X.shape[0]
    r, Xc, Rm, Km = _project_res(K, R, t, X, prob.obs_cam, prob.obs_pt,
                                 prob.obs_px)
    we = torch.where(Xc[:, 2] <= 1e-6, torch.zeros_like(w), w)
    Jc, Jp = _obs_jacobians(Km, Rm, Xc)
    # zero dead observations' Jacobians before the products: z ~ 0 rows
    # overflow float32 there, and 0 * inf = NaN
    live = (we > 0)[:, None, None]
    Jc = torch.where(live, Jc, torch.zeros_like(Jc))
    Jp = torch.where(live, Jp, torch.zeros_like(Jp))
    A_cc = torch.einsum("o,oki,okj->oij", we, Jc, Jc)
    A_pp = torch.einsum("o,oki,okj->oij", we, Jp, Jp)
    A_cp = torch.einsum("o,oki,okj->oij", we, Jc, Jp)
    gc_o = torch.einsum("o,oki,ok->oi", we, Jc, r)
    gp_o = torch.einsum("o,oki,ok->oi", we, Jp, r)
    Hcc = _segment_sum(A_cc, prob.obs_cam, M)
    Hpp = _segment_sum(A_pp, prob.obs_pt, P)
    Wcp = _segment_sum(A_cp, prob.obs_pt * M + prob.obs_cam,
                       P * M).reshape(P, M, 6, 3)
    gc = _segment_sum(gc_o, prob.obs_cam, M)
    gp = _segment_sum(gp_o, prob.obs_pt, P)
    cost = torch.sum(we * torch.sum(r * r, dim=-1))
    return Hcc, Wcp, Hpp, gc, gp, cost


def _schur_solve(Hcc, Wcp, Hpp, gc, gp, lam, cam_fixed, point_fixed):
    """One damped Gauss-Newton step by Schur elimination of the points."""
    M = Hcc.shape[0]
    dt, dev = Hcc.dtype, Hcc.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hcc_d = Hcc + lam * (eye6 * 1e-3 + Hcc * eye6)
    Hpp_d = Hpp + lam * (eye3 * 1e-3 + Hpp * eye3)
    # frozen points: identity block, no coupling, no right-hand side
    Hpp_d = torch.where(point_fixed[:, None, None], eye3, Hpp_d)
    zero = torch.zeros((), dtype=dt, device=dev)
    Wcp = torch.where(point_fixed[:, None, None, None], zero, Wcp)
    gp = torch.where(point_fixed[:, None], zero, gp)
    Hpp_inv = inv3x3_sym(Hpp_d + 1e-8 * eye3)              # [P, 3, 3]
    Y = torch.einsum("pmis,pst->pmit", Wcp, Hpp_inv)       # [P, M, 6, 3]
    S = -torch.einsum("pmit,pnjt->minj", Y, Wcp)           # [M, 6, M, 6]
    ar = torch.arange(M, device=dev)
    S[ar, :, ar, :] += Hcc_d
    rhs = gc - torch.einsum("pmit,pt->mi", Y, gp)          # [M, 6]
    # frozen cameras: identity rows and columns, no right-hand side
    free = (~cam_fixed).to(dt)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S[ar, :, ar, :] += eye6[None] * cam_fixed[:, None, None].to(dt)
    rhs = rhs * free[:, None]
    # solve_ex: a singular system gives a non-finite step, which the caller
    # rejects (as jnp.linalg.solve's does), instead of raising
    dc = -torch.linalg.solve_ex(S.reshape(M * 6, M * 6),
                                rhs.reshape(-1))[0].reshape(M, 6)
    # back-substitute the points: dX = -Hpp^{-1} (gp + W^T dc)
    Wt_dc = torch.einsum("pmis,mi->ps", Wcp, dc)
    dX = -torch.einsum("pst,pt->ps", Hpp_inv, gp + Wt_dc)
    return dc, dX


def bundle_adjust(prob: BAProblem, max_err: float = 10.0, max_iter: int = 2,
                  inner_iter: int = 10) -> BAResult:
    """Robust BA over an observation list: ``max_iter`` outer passes that
    reweight (Huber, Tukey on the last, tau = max_err), each of
    ``inner_iter`` damped Schur steps with accept/reject; outlier
    out-flags at the end (bundleAdjustRobust's contract)."""
    prob = prob._replace(obs_cam=prob.obs_cam.long(),
                         obs_pt=prob.obs_pt.long())
    dt = prob.X.dtype
    base_w = prob.obs_valid.to(dt)
    zero = torch.zeros((), dtype=dt, device=prob.X.device)
    R, t, X = prob.R, prob.t, prob.X
    args = (prob.obs_cam, prob.obs_pt, prob.obs_px)
    for k in range(max_iter):
        r, Xc, _, _ = _project_res(prob.K, R, t, X, *args)
        en = torch.linalg.norm(r, dim=-1)
        w_rob = huber_weight(en, max_err) if k < max_iter - 1 else \
            tukey_weight(en, max_err)
        w = base_w * w_rob * (Xc[:, 2] > 1e-6)
        lam = torch.full((), 1e-4, dtype=dt, device=X.device)
        for _ in range(inner_iter):
            Hcc, Wcp, Hpp, gc, gp, cost = _ba_normal_terms(prob.K, R, t, X,
                                                           prob, w)
            dc, dX = _schur_solve(Hcc, Wcp, Hpp, gc, gp, lam, prob.cam_fixed,
                                  prob.point_fixed)
            finite = torch.all(torch.isfinite(dc)) & \
                torch.all(torch.isfinite(dX))
            dc = torch.where(finite & ~prob.cam_fixed[:, None], dc, zero)
            dX = torch.where(finite & ~prob.point_fixed[:, None], dX, zero)
            dRs, dts = se3_exp(dc)
            R_new = dRs @ R
            t_new = torch.einsum("mij,mj->mi", dRs, t) + dts
            X_new = X + dX
            r_new, Xc_new, _, _ = _project_res(prob.K, R_new, t_new, X_new,
                                               *args)
            w_new = torch.where(Xc_new[:, 2] <= 1e-6, zero, w)
            cost_new = torch.sum(w_new * torch.sum(r_new * r_new, dim=-1))
            ok = (cost_new < cost) & finite
            R = torch.where(ok, R_new, R)
            t = torch.where(ok, t_new, t)
            X = torch.where(ok, X_new, X)
            lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 8.0),
                              1e-8, 1e8)
    R = orthonormalize_fast(R)
    r, Xc, _, _ = _project_res(prob.K, R, t, X, *args)
    err = torch.linalg.norm(r, dim=-1)
    outlier = prob.obs_valid & ((err > max_err) | (Xc[:, 2] <= 1e-6))
    w_fin = base_w * tukey_weight(err, max_err) * (Xc[:, 2] > 1e-6)
    cost = torch.sum(w_fin * torch.sum(r * r, dim=-1))
    return BAResult(R=R, t=t, X=X, obs_outlier=outlier, obs_err=err,
                    cost=cost)
