"""Loop closure within a camera group (the port of
``coslam_tpu/slam/loop.py``; the reference CoSLAM has no intra-group
closure: this drives the merge machinery at a group's own dormant map).

  1. candidate: enough dormant static points (unseen for
     ``loop_dormant_age`` frames) project into the current view, inside
     the live-feature hull;
  2. re-acquire: dense NCC template search around each dormant point's
     projection (``ops/ncc.py::ncc_search``, whose windows the window
     kernel cuts at G = 43);
  3. solve: a residual-field consensus of 1-match hypotheses (the drift
     correction is a small SE(3), so true matches share a coherent
     residual) and an IRLS polish;
  4. verify: consensus size and median reprojection error;
  5. commit: the graded correction of ``merge.apply_group_transform``
     from the loop's anchor frame to now (Sim(3): a depth-ratio scale),
     the dormant anchor map staying put, and the re-acquired points
     re-bound to live features.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from coslam_torch.config import SlamConfig
from coslam_torch.geometry.hull import convex_hull, points_in_hull
from coslam_torch.ops.ncc import ncc_search
from coslam_torch.slam.intercam import register_map_points
from coslam_torch.slam.merge import _project_np, apply_group_transform
from coslam_torch.slam.state import PT_STATIC, ST_ALIVE, SlamState
from coslam_torch.solvers.pose import irls_pose
from coslam_torch.util import to_host

LOOP_ANCHOR_CAP = 256      # dormant points searched per attempt


class LoopResult(NamedTuple):
    ok: bool
    state: SlamState
    cam: int
    n_inliers: int
    f_anchor: int
    scale: float = 1.0


def find_loop_candidates(state: SlamState, cfg: SlamConfig,
                         K: np.ndarray) -> list[tuple[int, int]]:
    """[(camera, count)] of the cameras whose current view holds at least
    ``loop_overlap_min`` dormant static points (inside the live-feature
    hull), best first."""
    p = cfg.p
    h, w = cfg.image_height, cfg.image_width
    mp, tr = state.mappts, state.tracks
    status, ptype, last_obs, xyz, R, t, pos, tvalid, frame = to_host(
        mp.status, mp.ptype, mp.last_obs, mp.xyz, state.R, state.t, tr.pos,
        tr.valid, state.frame)
    dormant = (status == ST_ALIVE) & (ptype == PT_STATIC) & \
        (int(frame) - last_obs >= p.loop_dormant_age)
    if dormant.sum() < p.loop_overlap_min:
        return []
    xyz = xyz[dormant]
    out = []
    for c in range(cfg.num_cameras):
        Xc = xyz @ R[c].T + t[c]
        u, v = _project_np(K[c], Xc)
        inside = (Xc[:, 2] > 1e-3) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        if tvalid[c].sum() >= 3:
            hull = convex_hull(pos[c][tvalid[c]])
            if len(hull) >= 3:
                inside &= points_in_hull(np.stack([u, v], -1), hull)
        n = int(inside.sum())
        if n >= p.loop_overlap_min:
            out.append((c, n))
    out.sort(key=lambda x: -x[1])
    return out


def close_loop(state: SlamState, cfg: SlamConfig, pyr, K, kc,
               group_id: np.ndarray, c: int, min_score: float = 0.62,
               search_radius: int = 16) -> LoopResult:
    """Attempt a loop closure anchored on camera ``c``'s dormant map (at
    most LOOP_ANCHOR_CAP points, whose projections lie far enough inside
    the image for the whole search window)."""
    p = cfg.p
    fail = LoopResult(False, state, c, 0, 0)
    mp, tr = state.mappts, state.tracks
    h, w = cfg.image_height, cfg.image_width
    (status, ptype, last_obs, ncc_valid, xyz, first_frame, R_old, t_old, Kc,
     pos_c, mpt_c, valid_c, frame) = to_host(
        mp.status, mp.ptype, mp.last_obs, mp.ncc_valid[:, c], mp.xyz,
        mp.first_frame, state.R[c], state.t[c], K[c], tr.pos[c], tr.mpt[c],
        tr.valid[c], state.frame)
    frame = int(frame)
    dormant = (status == ST_ALIVE) & (ptype == PT_STATIC) & \
        (frame - last_obs >= p.loop_dormant_age) & ncc_valid
    Xc0 = xyz @ R_old.T + t_old
    u, v = _project_np(Kc, Xc0)
    margin = p.ncc_patch_radius + search_radius + 1
    inview = dormant & (Xc0[:, 2] > 1e-3) & (u >= margin) & (v >= margin) \
        & (u < w - margin) & (v < h - margin)
    idx = np.nonzero(inview)[0][:LOOP_ANCHOR_CAP]
    if len(idx) < p.loop_min_inliers:
        return fail
    L = LOOP_ANCHOR_CAP
    idxp = np.zeros(L, np.int64)
    idxp[:len(idx)] = idx
    mask = np.arange(L) < len(idx)
    centers = np.stack([u[idxp], v[idxp]], -1).astype(np.float32)
    dev = mp.xyz.device
    # the templates are gathered on the device (the [P, 121] plane stays)
    templates = mp.ncc[torch.as_tensor(idxp, device=dev), c]
    best_px_t, score = ncc_search(pyr.imgs[0][c],
                                  torch.as_tensor(centers, device=dev),
                                  templates, search_radius=search_radius,
                                  patch_radius=p.ncc_patch_radius)
    best_px, score = to_host(best_px_t, score)
    good = mask & (score >= min_score)
    if good.sum() < p.loop_min_inliers:
        return fail
    # residual-field consensus: correct re-acquisitions share a coherent
    # residual (match - projection), mismatches on self-similar texture
    # spread over the search window
    r = best_px - centers
    dist = np.linalg.norm(r[:, None] - r[None], axis=-1)
    votes = (dist < 6.0) & good[None, :] & good[:, None]
    consensus = votes[int(np.argmax(votes.sum(1)))]
    n_inl = int(consensus.sum())
    if n_inl < p.loop_min_inliers:
        return fail
    # IRLS polish from the current pose over the consensus set
    pol = irls_pose(K[c], state.R[c], state.t[c],
                    torch.as_tensor(xyz[idxp], device=dev), best_px_t,
                    torch.as_tensor(consensus, device=dev), tau=6.0)
    R_new, t_new, err = to_host(pol.R, pol.t, pol.err)
    err = err[consensus]
    if len(err) < p.loop_min_inliers or float(np.median(err)) > 2.5:
        return fail
    # monocular scale evidence (Sim(3)): re-acquired anchor points against
    # the YOUNG points bound at (nearly) the same pixels; their depth
    # ratio under the respective poses is the accumulated scale drift
    scale = 1.0
    young_f = valid_c & (mpt_c >= 0) & \
        (first_frame[np.clip(mpt_c, 0, None)] > frame - p.loop_dormant_age)
    if young_f.sum() >= 5 and n_inl >= 5:
        ypix = pos_c[young_f]
        yslot = mpt_c[young_f]
        d = np.linalg.norm(best_px[consensus][:, None] - ypix[None], axis=-1)
        j = d.argmin(1)
        okp = d.min(1) < 3.0
        if okp.sum() >= 5:
            Xa = xyz[idxp][consensus][okp]
            Xy = xyz[yslot[j[okp]]]
            za = (Xa @ R_new.T + t_new)[:, 2]
            zy = (Xy @ R_old.T + t_old)[:, 2]
            ratio = za / np.maximum(zy, 1e-6)
            ratio = ratio[np.isfinite(ratio) & (ratio > 0)]
            if len(ratio) >= 5:
                lr = np.log(ratio)
                mad = float(np.median(np.abs(lr - np.median(lr))))
                s_est = float(np.exp(np.median(lr)))
                if mad < 0.25 and 0.5 < s_est < 2.0:
                    scale = s_est
    # graded correction over the drift window:
    # T_new = (R_old R_s^T, s t_old - R_new t_s)
    R_s = (R_new.T @ R_old).astype(np.float32)
    t_s = (R_new.T @ (scale * t_old - t_new)).astype(np.float32)
    f_anchor = int(np.median(last_obs[idxp][consensus]))
    st3 = apply_group_transform(state, cfg, group_id == group_id[c], R_s,
                                t_s, group_id, f_sep=f_anchor,
                                anchor_before=f_anchor + 1, scale=scale)
    # bind the re-acquired points to live features
    st3, _ = register_map_points(st3, pyr, K, cfg, min_age=p.loop_dormant_age,
                                 min_score=0.5, steal_young=True)
    return LoopResult(True, st3, c, n_inl, f_anchor, scale)
