"""Per-frame step functions, camera-batched (the port of the monocular part
of ``coslam_tpu/slam/steps.py``).

  advance_tracks       KLT + corner refill of dead slots (redetect)
  choose_grid_features one mapped static feature per image block
  pose_update          IRLS pose + Mahalanobis gating + sequential refine
  new_map_points       two-view triangulation of mature unmapped tracks
  push_pose_history    pose ring write
  lifecycle_update     false points -> free slots
  add_keyframe         keyframe ring snapshot
  build_ba_table / apply_ba_table_results
                       windowed BA table collection and write-back

Dynamic structure is expressed with masks and cumsum-rank compaction; the
JAX package's dropping scatters (``.at[i].set(..., mode="drop")``) go
through ``util.set_drop``, whose sentinel row keeps the steps free of host
syncs. Functions return new tensors; the state passed in is not modified.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from slambench.reference.frozen.config import SlamConfig
from slambench.reference.frozen.geometry.camera import undistort_points
from slambench.reference.frozen.geometry.se3 import orthonormalize_fast
from slambench.reference.frozen.geometry.triangulate import (inv3x3_sym_ln,
                                               seq_triangulate_update,
                                               solve3x3_sym_ln)
from slambench.reference.frozen.ops.corners import detect_corners
from slambench.reference.frozen.ops.klt import klt_track
from slambench.reference.frozen.ops.ncc import extract_ncc_blocks_batched
from slambench.reference.frozen.ops.pyramid import Pyramid
from slambench.reference.frozen.solvers.ba import BATableProblem
from slambench.reference.frozen.slam.classify import point_obs_table
from slambench.reference.frozen.slam.state import (LONG_STRIDE, PT_DYNAMIC, PT_STATIC,
                                     ST_ALIVE, ST_FALSE, ST_FREE,
                                     KeyframeStore, MapPoints, SlamState,
                                     TrackTable)
from slambench.reference.frozen.util import device_constant, nanmedian, set_drop


# ---------------------------------------------------------------------------
# ring helpers (index tensors, so nothing syncs with the host)
# ---------------------------------------------------------------------------

def _ring_get(x: torch.Tensor, i: torch.Tensor, dim: int = 1):
    return x.index_select(dim, i.reshape(1).long()).squeeze(dim)


def _ring_set(x: torch.Tensor, i: torch.Tensor, v: torch.Tensor,
              dim: int = 1):
    return x.index_copy(dim, i.reshape(1).long(), v.unsqueeze(dim))


def _rank_to_index(mask: torch.Tensor) -> torch.Tensor:
    """out[r] = index of the r-th True entry of ``mask`` (len(mask) where
    r >= count): one cumsum + one scatter instead of a sort."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    out = torch.full((n,), n, dtype=torch.int32, device=mask.device)
    return set_drop(out, torch.where(mask, rank, n),
                    torch.arange(n, dtype=torch.int32, device=mask.device))


# ---------------------------------------------------------------------------
# tracking + redetect
# ---------------------------------------------------------------------------

def _write_history(tracks_hist, hist_valid, hist_long, hist_long_valid,
                   pos, valid, frame):
    """Write the current entry into the dense ring and (every LONG_STRIDE
    frames) the long-horizon ring."""
    T = tracks_hist.shape[1]
    TL = hist_long.shape[1]
    s = torch.remainder(frame, T)
    hist = _ring_set(tracks_hist, s, pos)
    hist_valid = _ring_set(hist_valid, s, valid)
    li = torch.remainder(torch.div(frame, LONG_STRIDE, rounding_mode="floor"),
                         TL)
    wr = torch.remainder(frame, LONG_STRIDE) == 0
    hist_long = _ring_set(hist_long, li, torch.where(
        wr, pos, _ring_get(hist_long, li)))
    hist_long_valid = _ring_set(hist_long_valid, li, torch.where(
        wr, valid, _ring_get(hist_long_valid, li)))
    return hist, hist_valid, hist_long, hist_long_valid


def advance_tracks(pyr_prev: Pyramid, pyr_cur: Pyramid, tracks: TrackTable,
                   K: torch.Tensor, kc: torch.Tensor, frame: torch.Tensor,
                   cfg: SlamConfig) -> TrackTable:
    """KLT-track all slots, then refill dead slots from fresh corners (the
    every-frame redetect protocol)."""
    C, N = tracks.valid.shape
    res = klt_track(pyr_prev, pyr_cur, tracks.raw, tracks.valid, cfg.klt)
    survived = tracks.valid & res.valid
    raw = torch.where(survived[..., None], res.pos, tracks.raw)
    det = detect_corners(pyr_cur.imgs[0], pyr_cur.dxs[0], pyr_cur.dys[0],
                         cfg.klt, N, exclude_pos=raw, exclude_valid=survived)
    raws, newlies = [], []
    for c in range(C):
        # k-th detection fills the k-th free slot
        slot = _rank_to_index(~survived[c])          # [N], N where none
        use = det.valid[c] & (slot < N)
        tgt = torch.where(use, slot, N)
        raws.append(set_drop(raw[c], tgt, det.pos[c]))
        newlies.append(set_drop(torch.zeros_like(use), tgt, use))
    raw, newly = torch.stack(raws), torch.stack(newlies)
    valid = survived | newly
    one = torch.ones_like(tracks.age)
    zero = torch.zeros_like(tracks.age)
    age = torch.where(newly, one, torch.where(survived, tracks.age + 1, zero))
    mpt = torch.where(survived, tracks.mpt, -one)
    dyn_votes = torch.where(survived, tracks.dyn_votes, zero)
    gain = torch.where(newly, torch.ones_like(res.gain), res.gain)
    pos = undistort_points(raw, K[:, None], kc[:, None])
    # refilled slots' past is cleared before the current entry is written
    hist_valid = tracks.hist_valid & ~newly[:, None, :]
    hist_long_valid = tracks.hist_long_valid & ~newly[:, None, :]
    hist, hist_valid, hist_long, hist_long_valid = _write_history(
        tracks.hist, hist_valid, tracks.hist_long, hist_long_valid,
        pos, valid, frame)
    return TrackTable(pos=pos, raw=raw, valid=valid, age=age, gain=gain,
                      mpt=mpt, dyn_votes=dyn_votes, hist=hist,
                      hist_valid=hist_valid, hist_long=hist_long,
                      hist_long_valid=hist_long_valid)


# ---------------------------------------------------------------------------
# pose update
# ---------------------------------------------------------------------------

def choose_grid_features(tracks: TrackTable, mappts: MapPoints, img_hw,
                         cfg: SlamConfig) -> torch.Tensor:
    """One mapped static feature per image block (12x16 grid): returns a
    [C, N] selection mask."""
    C, N = tracks.valid.shape
    rows, cols = cfg.cap.pose_grid_rows, cfg.cap.pose_grid_cols
    h, w = img_hw
    mi = torch.clamp(tracks.mpt, min=0).long()
    pstat = (mappts.status[mi] == ST_ALIVE) & (mappts.ptype[mi] == PT_STATIC)
    cand = tracks.valid & (tracks.mpt >= 0) & pstat
    cy = torch.clamp((tracks.pos[..., 1] * rows / h).to(torch.int32),
                     0, rows - 1)
    cx = torch.clamp((tracks.pos[..., 0] * cols / w).to(torch.int32),
                     0, cols - 1)
    cell = (cy * cols + cx).long()
    ccx = (cx.to(tracks.pos.dtype) + 0.5) * (w / cols)
    ccy = (cy.to(tracks.pos.dtype) + 0.5) * (h / rows)
    prio = torch.hypot(tracks.pos[..., 0] - ccx, tracks.pos[..., 1] - ccy)
    prio = torch.where(cand, prio, torch.full_like(prio, math.inf))
    best = torch.full((C, rows * cols), math.inf, dtype=prio.dtype,
                      device=prio.device)
    best = best.scatter_reduce(1, cell, prio, reduce="amin",
                               include_self=True)
    return cand & (prio <= torch.gather(best, 1, cell)) & \
        torch.isfinite(prio)


class PoseUpdateOut(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    tracks: TrackTable
    mappts: MapPoints
    n_inliers: torch.Tensor    # [C]
    coverage: torch.Tensor     # [C] bbox area fraction of inlier features
    med_depth: torch.Tensor    # [C] median depth of mapped static points
    med_err: torch.Tensor      # [C]


def pose_update(state: SlamState, K: torch.Tensor, kc: torch.Tensor,
                img_hw, cfg: SlamConfig,
                large_err: bool = False) -> PoseUpdateOut:
    """Per-camera IRLS pose + Mahalanobis inlier/outlier gating +
    sequential map-point refinement (poseUpdate3D). ``large_err`` widens
    the IRLS tau and the outlier gate 2x (post-merge/loop settle frames)."""
    from slambench.reference.frozen.solvers.pose import irls_pose
    tracks, mappts = state.tracks, state.mappts
    C, N = tracks.valid.shape
    p = cfg.p
    dev = tracks.pos.device
    sel = choose_grid_features(tracks, mappts, img_hw, cfg)
    mi = torch.clamp(tracks.mpt, min=0).long()
    X = mappts.xyz[mi]                                  # [C, N, 3]
    wide = 2.0 if large_err else 1.0
    # 4x8 IRLS-LM iterations: frame-to-frame pose deltas are small
    sol = irls_pose(K, state.R, state.t, X, tracks.pos, sel,
                    p.max_err * wide, n_irls=4, n_lm=8)
    R_new, t_new = sol.R, sol.t
    # keep the previous pose if too few points were selected, the solve
    # blew up, or the motion is impossible for one frame
    n_sel = torch.sum(sel, dim=1)
    z_old = torch.einsum("cj,cnj->cn", state.R[:, 2], X) + state.t[:, 2:3]
    nan = torch.full_like(z_old, math.nan)
    med_z_old = nanmedian(torch.where(sel & (z_old > 1e-3), z_old, nan), 1)
    med_z_old = torch.where(torch.isfinite(med_z_old) & (med_z_old > 1e-3),
                            med_z_old, torch.full_like(med_z_old, 10.0))
    c_old = -torch.einsum("cji,cj->ci", state.R, state.t)
    c_new = -torch.einsum("cji,cj->ci", R_new, t_new)
    jump = torch.linalg.norm(c_new - c_old, dim=-1)
    tr_rel = torch.einsum("cij,cij->c", R_new, state.R)
    ang_rel = torch.arccos(torch.clamp((tr_rel - 1.0) * 0.5, -1.0, 1.0))
    ok_cam = (n_sel >= 5) & torch.isfinite(R_new).all(dim=2).all(dim=1) \
        & torch.isfinite(t_new).all(dim=1) \
        & (jump < 0.5 * med_z_old) & (ang_rel < 0.61)
    R_new = torch.where(ok_cam[:, None, None], R_new, state.R)
    t_new = torch.where(ok_cam[:, None], t_new, state.t)

    # Mahalanobis gating of all mapped static features under the new pose
    mapped = tracks.valid & (tracks.mpt >= 0) & \
        (mappts.status[mi] == ST_ALIVE)
    is_static = mappts.ptype[mi] == PT_STATIC
    fxc, fyc = K[:, 0, 0, None], K[:, 1, 1, None]
    cxc, cyc = K[:, 0, 2, None], K[:, 1, 2, None]
    Xg = [X[..., i] for i in range(3)]                       # 3 x [C, N]
    covX = mappts.cov[mi]                                    # [C, N, 3, 3]
    cov_g = [[covX[..., i, j] for j in range(3)] for i in range(3)]
    Rm, tm = R_new, t_new
    Xc = [Rm[:, i, 0, None] * Xg[0] + Rm[:, i, 1, None] * Xg[1]
          + Rm[:, i, 2, None] * Xg[2] + tm[:, i, None] for i in range(3)]
    zdep = Xc[2]
    zi = 1.0 / torch.where(torch.abs(zdep) < 1e-9,
                           torch.full_like(zdep, 1e-9), zdep)
    u = fxc * Xc[0] * zi + cxc
    v = fyc * Xc[1] * zi + cyc
    xz = Xc[0] * zi
    yz = Xc[1] * zi
    Ju = [fxc * (Rm[:, 0, j, None] - xz * Rm[:, 2, j, None]) * zi
          for j in range(3)]
    Jv = [fyc * (Rm[:, 1, j, None] - yz * Rm[:, 2, j, None]) * zi
          for j in range(3)]
    rx = tracks.pos[..., 0] - u                              # innovation
    ry = tracks.pos[..., 1] - v
    cJu = [sum(cov_g[i][j] * Ju[j] for j in range(3)) for i in range(3)]
    cJv = [sum(cov_g[i][j] * Jv[j] for j in range(3)) for i in range(3)]
    s00 = sum(Ju[i] * cJu[i] for i in range(3)) + p.pixel_err_var
    s01 = sum(Ju[i] * cJv[i] for i in range(3))
    s11 = sum(Jv[i] * cJv[i] for i in range(3)) + p.pixel_err_var
    det = s00 * s11 - s01 * s01
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                      det)
    maha2 = (s11 * rx * rx - 2.0 * s01 * rx * ry + s00 * ry * ry) / det
    out_gate = (p.maha_outlier * wide) ** 2
    in_gate = p.maha_inlier ** 2
    outlier = mapped & is_static & (maha2 > out_gate)
    inlier = mapped & is_static & (maha2 <= in_gate)
    # outliers detach from the map (the point itself survives)
    mpt = torch.where(outlier, torch.full_like(tracks.mpt, -1), tracks.mpt)
    tracks = tracks._replace(mpt=mpt)

    # sequential refinement of inlier static points, camera by camera (the
    # information-filter ordering); only the updated points are written
    P = mappts.xyz.shape[0]
    xyz, cov = mappts.xyz, mappts.cov
    err = torch.hypot(rx, ry)
    for c in range(C):
        Xp = xyz[mi[c]]
        Cp = cov[mi[c]]
        Xn, Cn, _ = seq_triangulate_update(
            K[c], R_new[c], t_new[c], tracks.pos[c], Xp, Cp,
            pixel_var=p.pixel_err_var, gate_maha2=in_gate)
        tgt = torch.where(inlier[c], mi[c], P)
        xyz = set_drop(xyz, tgt, Xn)
        cov = set_drop(cov, tgt, Cn)
    # observation bookkeeping
    obs = mapped & ~outlier
    seen = set_drop(torch.zeros((P,), dtype=torch.bool, device=dev),
                    torch.where(obs, mpt, P).reshape(-1), True)
    last_obs = torch.where(seen, state.frame, mappts.last_obs)
    # ownership: lowest camera currently observing
    owner = mappts.owner
    for c in range(C - 1, -1, -1):
        owner = set_drop(owner, torch.where(obs[c], mpt[c], P), c)
    mappts = mappts._replace(xyz=xyz, cov=cov, last_obs=last_obs,
                             owner=owner)

    # stats
    nan = torch.full_like(zdep, math.nan)
    med_depth = nanmedian(torch.where(mapped & is_static, zdep, nan), 1)
    med_err = nanmedian(torch.where(inlier, err, nan), 1)
    h, w = img_hw
    inf = torch.full_like(zdep, math.inf)
    px, py = tracks.pos[..., 0], tracks.pos[..., 1]
    span_x = torch.where(inlier, px, -inf).amax(1) - \
        torch.where(inlier, px, inf).amin(1)
    span_y = torch.where(inlier, py, -inf).amax(1) - \
        torch.where(inlier, py, inf).amin(1)
    cov_frac = span_x * span_y / float(h * w)
    cov_frac = torch.where(torch.isfinite(cov_frac), cov_frac,
                           torch.zeros_like(cov_frac))
    return PoseUpdateOut(R=R_new, t=t_new, tracks=tracks, mappts=mappts,
                         n_inliers=torch.sum(inlier, 1), coverage=cov_frac,
                         med_depth=med_depth, med_err=med_err)


# ---------------------------------------------------------------------------
# new map points (intra-camera)
# ---------------------------------------------------------------------------

def _history_offsets(T: int) -> np.ndarray:
    """Second-view candidates: every history offset at T <= 9, else a
    log-spaced subset of [1, T-2] plus T-1."""
    if T <= 9:
        return np.arange(1, T)
    geo = np.rint(np.geomspace(1, T - 2, 7)).astype(int)
    return np.unique(np.concatenate([geo, [T - 1]]))


@functools.lru_cache(maxsize=None)
def _max_parallax_cos(deg: float) -> float:
    """cos of the minimum parallax angle, rounded to float32 as the
    reference computes it (a Python float, so the comparison needs no
    tensor on the device)."""
    return float(torch.cos(torch.deg2rad(torch.tensor(deg,
                                                      dtype=torch.float32))))


def new_map_points(state: SlamState, pyr_cur: Pyramid, K: torch.Tensor,
                   kc: torch.Tensor, cfg: SlamConfig, blocks=None):
    """Triangulation of mature unmapped tracks against the parallax-widest
    history view, refined over the whole track history and re-checked at
    both endpoint views (newMapPoints + refineTriangulation); NCC
    appearance refresh; slot allocation. Returns (mappts', tracks', n_new).
    ``blocks``: optional ([C, N, B] NCC blocks, [C, N] mask) at
    ``tracks.raw``, cut beforehand (``pyr_cur`` is then not read)."""
    tracks, mappts = state.tracks, state.mappts
    C, N = tracks.valid.shape
    T = tracks.hist.shape[1]
    P = mappts.xyz.shape[0]
    p = cfg.p
    dev = tracks.pos.device
    dt = tracks.pos.dtype
    frame = state.frame
    cand = tracks.valid & (tracks.mpt < 0) & \
        (tracks.age >= p.min_feat_track_len) & (tracks.dyn_votes < 3)
    fx = K[:, 0, 0][:, None, None]
    fy = K[:, 1, 1][:, None, None]
    cx = K[:, 0, 2][:, None, None]
    cy = K[:, 1, 2][:, None, None]
    x_now = (tracks.pos[..., 0][:, None] - cx) / fx                # [C,1,N]
    y_now = (tracks.pos[..., 1][:, None] - cy) / fy
    offs = _history_offsets(T)
    Ts = len(offs)
    ages = torch.clamp(tracks.age - 1, max=T - 1)
    k_off = device_constant(("history_offsets", T), dev,
                            lambda: torch.as_tensor(offs, dtype=torch.int32))
    past_frame = frame - k_off                                     # [Ts]
    ring = torch.remainder(past_frame, T).long()
    hist_pos = tracks.hist.index_select(1, ring)                   # [C,Ts,N,2]
    hx = hist_pos[..., 0]
    hy = hist_pos[..., 1]
    hist_ok = tracks.hist_valid.index_select(1, ring) & \
        (k_off[None, :, None] >= 1) & \
        (k_off[None, :, None] <= ages[:, None]) & \
        (past_frame[None, :, None] >= 0)
    Rp = state.pose_hist_R.index_select(1, ring)                   # [C,Ts,3,3]
    tp = state.pose_hist_t.index_select(1, ring)                   # [C,Ts,3]
    x_past = (hx - cx) / fx                                        # [C,Ts,N]
    y_past = (hy - cy) / fy
    # second-view selection by ray-angle parallax
    R = state.R
    dn = [R[:, 0, i][:, None, None] * x_now
          + R[:, 1, i][:, None, None] * y_now
          + R[:, 2, i][:, None, None] for i in range(3)]        # [C,1,N]
    dp = [Rp[:, :, 0, i][:, :, None] * x_past
          + Rp[:, :, 1, i][:, :, None] * y_past
          + Rp[:, :, 2, i][:, :, None] for i in range(3)]       # [C,Ts,N]
    num = dn[0] * dp[0] + dn[1] * dp[1] + dn[2] * dp[2]
    den2 = (dn[0] * dn[0] + dn[1] * dn[1] + dn[2] * dn[2]) * \
        (dp[0] * dp[0] + dp[1] * dp[1] + dp[2] * dp[2])
    pcos = num * torch.rsqrt(torch.clamp(den2, min=1e-18))
    max_cos = _max_parallax_cos(float(p.new_point_min_parallax_deg))
    gate2 = p.reproj_new_point_gate ** 2
    good = hist_ok & (torch.abs(pcos) < max_cos)
    score = torch.where(good, -torch.abs(pcos),
                        torch.full_like(pcos, -math.inf))
    best_k = torch.argmax(score, dim=1)                            # [C,N]
    any_good = torch.any(good, dim=1)

    def takeT(A):
        return torch.gather(A, 1, best_k[:, None, :])[:, 0]

    cam = torch.arange(C, device=dev)[:, None]
    Rb = Rp[cam, best_k]                                           # [C,N,3,3]
    tb = tp[cam, best_k]                                           # [C,N,3]
    Rb9 = [[Rb[..., i, j] for j in range(3)] for i in range(3)]
    tb3 = [tb[..., i] for i in range(3)]
    R_cur = [[R[:, i, j, None].expand(C, N) for j in range(3)]
             for i in range(3)]
    t_cur = [state.t[:, i, None].expand(C, N) for i in range(3)]

    def _solve_chain(w_hist):
        """Weighted multi-view DLT over the current view (weight 1) and
        the Ts history views (weights [C, Ts, N])."""
        Hh = [[torch.full((C, N), 1e-9 if i == j else 0.0, dtype=dt,
                          device=dev) for j in range(3)] for i in range(3)]
        gh = [torch.zeros((C, N), dtype=dt, device=dev) for _ in range(3)]

        def acc(Rm, tm, xn, yn, wc):
            M1 = [xn * Rm[2][j] - Rm[0][j] for j in range(3)]
            M2 = [yn * Rm[2][j] - Rm[1][j] for j in range(3)]
            b1 = tm[0] - xn * tm[2]
            b2 = tm[1] - yn * tm[2]
            for i in range(3):
                for j in range(i + 1):
                    Hh[i][j] = Hh[i][j] + wc * (M1[i] * M1[j]
                                                + M2[i] * M2[j])
                gh[i] = gh[i] + wc * (M1[i] * b1 + M2[i] * b2)

        acc(R_cur, t_cur, x_now[:, 0], y_now[:, 0],
            torch.ones((C, N), dtype=dt, device=dev))
        for k in range(Ts):
            Rk = [[Rp[:, k, i, j][:, None] for j in range(3)]
                  for i in range(3)]
            tk = [tp[:, k, i][:, None] for i in range(3)]
            acc(Rk, tk, x_past[:, k], y_past[:, k], w_hist[:, k])
        return solve3x3_sym_ln(Hh, gh)                     # 3 x [C,N]

    def _reproj_err2_at(Xq, Rm, tm, px_x, px_y):
        Xc = [Rm[i][0] * Xq[0] + Rm[i][1] * Xq[1] + Rm[i][2] * Xq[2]
              + tm[i] for i in range(3)]
        z = Xc[2]
        zi = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9),
                               z)
        du = fx[:, 0] * Xc[0] * zi + cx[:, 0] - px_x
        dv = fy[:, 0] * Xc[1] * zi + cy[:, 0] - px_y
        return du * du + dv * dv, z

    # single strict pass over every valid history view, then the endpoint
    # recheck on the full-chain fit
    Xb = _solve_chain(hist_ok.to(dt))
    e2r_now, z_now = _reproj_err2_at(Xb, R_cur, t_cur, tracks.pos[..., 0],
                                     tracks.pos[..., 1])
    e2r_past, z_past = _reproj_err2_at(Xb, Rb9, tb3, takeT(hx), takeT(hy))
    refine_ok = (e2r_now < gate2) & (e2r_past < gate2) & \
        (z_now > 1e-3) & (z_past > 1e-3)
    X_new = torch.stack(Xb, dim=-1)                                # [C,N,3]
    alloc = cand & any_good & refine_ok
    # covariance from the two chosen views: pixel-space J^T J
    Hpx = [[torch.full((C, N), 1e-9 if i == j else 0.0, dtype=dt,
                       device=dev) for j in range(3)] for i in range(3)]
    fx2, fy2 = fx[:, 0], fy[:, 0]                                  # [C,1]
    for Rv, tv in ((R_cur, t_cur), (Rb9, tb3)):
        Xc = [Rv[i][0] * Xb[0] + Rv[i][1] * Xb[1] + Rv[i][2] * Xb[2] + tv[i]
              for i in range(3)]
        z = Xc[2]
        zi = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9),
                               z)
        xz = Xc[0] * zi
        yz = Xc[1] * zi
        Ju = [fx2 * (Rv[0][j] - xz * Rv[2][j]) * zi for j in range(3)]
        Jv = [fy2 * (Rv[1][j] - yz * Rv[2][j]) * zi for j in range(3)]
        for i in range(3):
            for j in range(i + 1):
                Hpx[i][j] = Hpx[i][j] + Ju[i] * Ju[j] + Jv[i] * Jv[j]
    Hinv = inv3x3_sym_ln(Hpx)
    covs = torch.stack([torch.stack(r) for r in Hinv]).permute(2, 3, 0, 1) \
        * p.pixel_err_var                                          # [C,N,3,3]
    # NCC appearance at the current frame
    if blocks is None:
        blocks, blk_ok = extract_ncc_blocks_batched(
            pyr_cur.imgs[0], tracks.raw, p.ncc_patch_radius)
    else:
        blocks, blk_ok = blocks
    # refresh stored appearance of observed points while the new view still
    # resembles the stored one (NCC >= 0.8)
    mi_b = torch.clamp(tracks.mpt, min=0).long()
    old_blk = mappts.ncc[mi_b, cam]                                # [C,N,B]
    old_ok = mappts.ncc_valid[mi_b, cam]
    sim = torch.einsum("cnb,cnb->cn", old_blk, blocks)
    mapped_b = tracks.valid & (tracks.mpt >= 0) & blk_ok
    refresh = mapped_b & ((sim >= 0.8) | ~old_ok)
    cam_of = torch.div(torch.arange(C * N, device=dev), N,
                       rounding_mode="floor")
    obs_slot = torch.where(refresh, tracks.mpt, P).reshape(-1)
    flat_blocks = blocks.reshape(C * N, -1)
    ncc = set_drop(mappts.ncc, (obs_slot, cam_of), flat_blocks)
    ncc_valid = set_drop(mappts.ncc_valid, (obs_slot, cam_of), True)
    # ---- allocate map slots (free-list via cumsum-rank scatter) ----
    flat_alloc = alloc.reshape(-1)
    idx_of_rank = _rank_to_index(mappts.status == ST_FREE)  # P where none
    want_rank = torch.cumsum(flat_alloc.to(torch.int64), 0) - 1
    slot = idx_of_rank[torch.clamp(want_rank, 0, P - 1)].long()
    can = flat_alloc & (slot < P)
    slot = torch.where(can, slot, P)                        # P = drop
    i32 = torch.int32
    mappts = MapPoints(
        xyz=set_drop(mappts.xyz, slot, X_new.reshape(-1, 3)),
        cov=set_drop(mappts.cov, slot, covs.reshape(-1, 3, 3)),
        gen=set_drop(mappts.gen, slot, torch.ones_like(slot, dtype=i32),
                     accumulate=True),              # invalidates old kf obs
        status=set_drop(mappts.status, slot, ST_ALIVE),
        ptype=set_drop(mappts.ptype, slot, PT_STATIC),
        first_frame=set_drop(mappts.first_frame, slot, frame),
        last_obs=set_drop(mappts.last_obs, slot, frame),
        bad_votes=set_drop(mappts.bad_votes, slot, 0),
        moved_votes=set_drop(mappts.moved_votes, slot, 0),
        owner=set_drop(mappts.owner, slot, cam_of.to(i32)),
        ncc=set_drop(ncc, (slot, cam_of), flat_blocks),
        ncc_valid=set_drop(ncc_valid, (slot, cam_of), blk_ok.reshape(-1)))
    mpt = torch.where((slot < P).reshape(C, N), slot.reshape(C, N).to(i32),
                      tracks.mpt)
    return mappts, tracks._replace(mpt=mpt), torch.sum(can)


# ---------------------------------------------------------------------------
# keyframes + BA window
# ---------------------------------------------------------------------------

def add_keyframe(state: SlamState) -> KeyframeStore:
    """Snapshot the current poses, observations and up to D alive dynamic
    points into the next keyframe ring slot."""
    kfs = state.kfs
    KF = kfs.frame.shape[0]
    D = kfs.dyn_xyz.shape[1]
    P = state.mappts.xyz.shape[0]
    w = torch.remainder(kfs.n, KF)
    tracks = state.tracks
    mapped = tracks.valid & (tracks.mpt >= 0)
    mi = torch.clamp(tracks.mpt, min=0).long()
    dyn = (state.mappts.status == ST_ALIVE) & \
        (state.mappts.ptype == PT_DYNAMIC)
    pt_of_d = _rank_to_index(dyn)[:D]            # [D], P where none
    d_ok = pt_of_d < P
    pt_c = torch.clamp(pt_of_d, 0, P - 1).long()
    _, obs_px, obs_ok = point_obs_table(tracks, P)         # [P,C,2],[P,C]
    dyn_px = obs_px[pt_c].transpose(0, 1)        # [C, D, 2]
    dyn_ok = (obs_ok[pt_c] & d_ok[:, None]).T    # [C, D]

    def put(arr, v):
        return _ring_set(arr, w, v, dim=0)

    return KeyframeStore(
        frame=put(kfs.frame, state.frame), R=put(kfs.R, state.R),
        t=put(kfs.t, state.t), obs_pos=put(kfs.obs_pos, tracks.pos),
        obs_mpt=put(kfs.obs_mpt, torch.where(mapped, tracks.mpt,
                                             torch.full_like(tracks.mpt, -1))),
        obs_gen=put(kfs.obs_gen, state.mappts.gen[mi]),
        dyn_xyz=put(kfs.dyn_xyz, state.mappts.xyz[pt_c]),
        dyn_obs_px=put(kfs.dyn_obs_px, dyn_px),
        dyn_obs_ok=put(kfs.dyn_obs_ok, dyn_ok),
        n=kfs.n + 1)


def build_ba_table(state: SlamState, K: torch.Tensor, cfg: SlamConfig,
                   window: int | None = None):
    """Dense [S, P] window table for ``bundle_adjust_table``
    (S = window x cameras): recycled-slot rejection via generations, a
    >= 2-observation requirement, pre-window points as anchors, and a
    2-keyframe gauge (all poses fixed until the window fills). Each
    keyframe's dynamic snapshot adds independent landmark columns.
    ``window`` overrides the keyframe count and frees the mid-window poses
    even while the window is only partly filled: the merge- and loop-time
    joint BA, whose point is to absorb the drift of a separation. Returns
    (BATableProblem, ring [W], kf_ok [W])."""
    kfs, mappts = state.kfs, state.mappts
    KF, C, N = kfs.obs_mpt.shape
    P = mappts.xyz.shape[0]
    W = min(window or cfg.cap.ba_window, KF)
    S = W * C
    dev = K.device
    arW = torch.arange(W, device=dev)
    start = torch.clamp(kfs.n - W, min=0)
    kf_ord = start + arW
    kf_ok = kf_ord < kfs.n
    ring = torch.remainder(kf_ord, KF).long()
    Rw = kfs.R[ring].reshape(S, 3, 3)
    tw = kfs.t[ring].reshape(S, 3)
    obs_pos = kfs.obs_pos[ring]                     # [W, C, N, 2]
    obs_mpt = kfs.obs_mpt[ring]
    obs_gen = kfs.obs_gen[ring]
    mi = torch.clamp(obs_mpt, min=0).long()
    pt_ok = (mappts.status[mi] == ST_ALIVE) & \
        (mappts.ptype[mi] == PT_STATIC) & (mappts.gen[mi] == obs_gen)
    ok = (obs_mpt >= 0) & pt_ok & kf_ok[:, None, None]
    slot_of = (arW[:, None, None] * C + torch.arange(C, device=dev)[
        None, :, None]).expand(W, C, N).reshape(-1)
    tgt = torch.where(ok, obs_mpt, P).reshape(-1)   # P = drop
    # tables built point-major ([P, S]) so the dropping index leads
    tbl_ok = set_drop(torch.zeros((P, S), dtype=torch.bool, device=dev),
                      (tgt, slot_of), True).T
    tbl_u = set_drop(torch.zeros((P, S), dtype=obs_pos.dtype, device=dev),
                     (tgt, slot_of), obs_pos[..., 0].reshape(-1)).T
    tbl_v = set_drop(torch.zeros((P, S), dtype=obs_pos.dtype, device=dev),
                     (tgt, slot_of), obs_pos[..., 1].reshape(-1)).T
    cnt = torch.sum(tbl_ok, dim=0)
    oldest = ring.index_select(0, torch.argmax(kf_ok.to(torch.int32))[None])
    oldest_frame = kfs.frame.index_select(0, oldest)[0]
    point_fixed = (cnt < 2) | (mappts.first_frame < oldest_frame)
    valid = tbl_ok & (cnt >= 2)[None]
    kf_fixed = (arW < 2) | ~kf_ok
    if window is None:
        kf_fixed = kf_fixed | (torch.sum(kf_ok) < W)
    cam_fixed = kf_fixed[:, None].expand(W, C).reshape(S)
    # dynamic-snapshot columns: [P static | W*D dyn (padded to 128)]
    D = kfs.dyn_xyz.shape[1]
    E = -(-(W * D) // 128) * 128
    dyn_px = kfs.dyn_obs_px[ring]                # [W, C, D, 2]
    dyn_ok = kfs.dyn_obs_ok[ring] & kf_ok[:, None, None]
    eyeW = torch.eye(W, dtype=torch.bool, device=dev)
    ok_ext = dyn_ok[:, :, None, :] & eyeW[:, None, :, None]  # [W,C,W,D]
    zero = torch.zeros((), dtype=obs_pos.dtype, device=dev)
    u_ext = torch.where(ok_ext, dyn_px[:, :, None, :, 0], zero)
    v_ext = torch.where(ok_ext, dyn_px[:, :, None, :, 1], zero)
    pad = E - W * D
    ok_ext = torch.nn.functional.pad(ok_ext.reshape(S, W * D), (0, pad))
    u_ext = torch.nn.functional.pad(u_ext.reshape(S, W * D), (0, pad))
    v_ext = torch.nn.functional.pad(v_ext.reshape(S, W * D), (0, pad))
    cnt_ext = torch.sum(ok_ext, dim=0)
    ok_ext = ok_ext & (cnt_ext >= 2)[None]
    X_ext = torch.nn.functional.pad(
        kfs.dyn_xyz[ring].reshape(W * D, 3).to(obs_pos.dtype),
        (0, 0, 0, pad))
    prob = BATableProblem(
        K=K[None].expand(W, C, 3, 3).reshape(S, 3, 3),
        R=Rw, t=tw,
        X=torch.cat([mappts.xyz, X_ext], dim=0),
        obs_px=torch.cat([torch.stack([tbl_u, tbl_v], dim=1),
                          torch.stack([u_ext, v_ext], dim=1)], dim=2),
        obs_valid=torch.cat([valid, ok_ext], dim=1),
        cam_fixed=cam_fixed,
        point_fixed=torch.cat([point_fixed, cnt_ext < 2]))
    return prob, ring, kf_ok


def apply_ba_table_results(state: SlamState, res, ring: torch.Tensor,
                           kf_ok: torch.Tensor, cfg: SlamConfig,
                           gen0: torch.Tensor | None = None) -> SlamState:
    """Write back a BATableResult: per-point outlier counts come from the
    [S, P] flag table; columns beyond the map capacity (dynamic snapshots)
    constrain the solve but are not written back.

    ``gen0``: the map slots' generations when the solve was dispatched.
    A deferred (asynchronous) result skips the slots that were reclaimed
    and re-minted while it was in flight: their point is another one now
    (the reference's mutex-guarded deferred write-back)."""
    P = state.mappts.xyz.shape[0]
    n_bad = torch.sum(res.obs_outlier[:, :P], dim=0)
    n_obs = torch.sum(res.obs_valid[:, :P], dim=0)
    return _apply_ba_core(state, res.R, res.t, res.X[:P], n_bad, n_obs,
                          ring, kf_ok, cfg, gen0)


def _apply_ba_core(state: SlamState, R_res, t_res, X_res, n_bad, n_obs,
                   ring, kf_ok, cfg: SlamConfig, gen0=None):
    kfs, mappts = state.kfs, state.mappts
    C = kfs.R.shape[1]
    W = ring.shape[0]
    R_new = R_res.reshape(W, C, 3, 3)
    t_new = t_res.reshape(W, C, 3)
    # divergence gate: a solution that moves any window camera center by a
    # large fraction of the scene depth (or spins it > 35 deg) ran away on
    # a degenerate window; the whole write-back is skipped then
    R_win_old = kfs.R[ring]                                 # [W, C, 3, 3]
    t_win_old = kfs.t[ring]
    c_w_old = -torch.einsum("wcji,wcj->wci", R_win_old, t_win_old)
    c_w_new = -torch.einsum("wcji,wcj->wci", R_new, t_new)
    jump_w = torch.linalg.norm(c_w_new - c_w_old, dim=-1)   # [W, C]
    tr_w = torch.einsum("wcij,wcij->wc", R_new, R_win_old)
    ang_w = torch.arccos(torch.clamp((tr_w - 1.0) * 0.5, -1.0, 1.0))
    z_map = torch.einsum("cj,pj->cp", state.R[:, 2], mappts.xyz) \
        + state.t[:, 2:3]
    alive0 = mappts.status == ST_ALIVE
    med_z = nanmedian(torch.where(alive0[None] & (z_map > 1e-3), z_map,
                                  torch.full_like(z_map, math.nan)), 1)
    med_z = torch.where(torch.isfinite(med_z) & (med_z > 1e-3), med_z,
                        torch.full_like(med_z, 10.0))
    okm = kf_ok[:, None]
    ba_ok = torch.all(~okm | (jump_w < 0.5 * med_z[None])) \
        & torch.all(~okm | (ang_w < 0.61)) \
        & torch.all(torch.isfinite(R_new)) & torch.all(torch.isfinite(t_new))
    okw = (kf_ok & ba_ok)[:, None, None, None]
    kfs = kfs._replace(
        R=kfs.R.index_copy(0, ring, torch.where(okw, R_new, R_win_old)),
        t=kfs.t.index_copy(0, ring, torch.where(okw[..., 0], t_new,
                                                t_win_old)))
    same = torch.ones_like(mappts.gen, dtype=torch.bool) if gen0 is None \
        else mappts.gen == gen0
    xyz = torch.where((same & ba_ok)[:, None], X_res, mappts.xyz)
    # outlier -> setFalse, hardened: a point dies only if most of its
    # window observations are outliers, and no kills are applied when the
    # solve would condemn a large fraction of the participating points
    alive = mappts.status == ST_ALIVE
    kill = (2 * n_bad > n_obs) & (n_obs > 0) & same & alive
    n_part = torch.sum((n_obs > 0) & alive)
    solve_sane = (torch.sum(kill) * 10 <= n_part * 3) & ba_ok
    status = torch.where(kill & solve_sane,
                         torch.full_like(mappts.status, ST_FALSE),
                         mappts.status)
    mappts = mappts._replace(xyz=xyz, status=status)
    # carry the newest keyframe's correction rigidly onto the live pose and
    # the pose history
    newest = ring[W - 1:W]
    R_old = state.kfs.R.index_select(0, newest)[0]
    t_old = state.kfs.t.index_select(0, newest)[0]
    R_upd = kfs.R.index_select(0, newest)[0]
    t_upd = kfs.t.index_select(0, newest)[0]
    D_R = orthonormalize_fast(torch.einsum("cji,cjk->cik", R_old, R_upd))
    D_t = torch.einsum("cji,cj->ci", R_old, t_upd - t_old)
    R_cur = orthonormalize_fast(torch.einsum("cij,cjk->cik", state.R, D_R))
    t_cur = torch.einsum("cij,cj->ci", state.R, D_t) + state.t
    ph_R = orthonormalize_fast(
        torch.einsum("ctij,cjk->ctik", state.pose_hist_R, D_R))
    ph_t = torch.einsum("ctij,cj->cti", state.pose_hist_R, D_t) \
        + state.pose_hist_t
    phl_R = orthonormalize_fast(
        torch.einsum("ctij,cjk->ctik", state.pose_hist_long_R, D_R))
    phl_t = torch.einsum("ctij,cj->cti", state.pose_hist_long_R, D_t) \
        + state.pose_hist_long_t
    return state._replace(R=R_cur, t=t_cur, kfs=kfs, mappts=mappts,
                          pose_hist_R=ph_R, pose_hist_t=ph_t,
                          pose_hist_long_R=phl_R, pose_hist_long_t=phl_t)


def push_pose_history(state: SlamState) -> SlamState:
    """Record the current pose into the ring slot for the current frame
    (after pose_update, aligned with the track-history write)."""
    T = state.pose_hist_R.shape[1]
    TL = state.pose_hist_long_R.shape[1]
    frame = state.frame
    s = torch.remainder(frame, T)
    sl = torch.remainder(torch.div(frame, LONG_STRIDE,
                                   rounding_mode="floor"), TL)
    wr = torch.remainder(frame, LONG_STRIDE) == 0
    return state._replace(
        pose_hist_R=_ring_set(state.pose_hist_R, s, state.R),
        pose_hist_t=_ring_set(state.pose_hist_t, s, state.t),
        pose_hist_long_R=_ring_set(state.pose_hist_long_R, sl, torch.where(
            wr, state.R, _ring_get(state.pose_hist_long_R, sl))),
        pose_hist_long_t=_ring_set(state.pose_hist_long_t, sl, torch.where(
            wr, state.t, _ring_get(state.pose_hist_long_t, sl))))


def lifecycle_update(mappts: MapPoints, frame, cfg: SlamConfig) -> MapPoints:
    """False points are reclaimed as free slots."""
    return mappts._replace(status=torch.where(
        mappts.status == ST_FALSE, torch.full_like(mappts.status, ST_FREE),
        mappts.status))
