"""Camera-group merge: overlap candidates, the wide-baseline bridge, the
graded group realignment, duplicate fusion, and the periodic duplicate
unification (the port of ``coslam_tpu/slam/merge.py``).

Replaces ``MergeCameraGroup`` (candidates by mutual map-point projection
overlap and camera distance, the bridge between the two cameras, the
pose graph with one merge edge, duplicate fusion, group-set merging).
Group SPLIT is implicit: camera grouping recomputes connected components
on every grouping tick.

The bridge (``merge_groups``): static-only NCC matches between the two
bridging cameras under a disparity bound, PnP of the moving camera
against the anchor group's map (PROSAC RANSAC, IRLS polish), a camera
pose graph with that metric edge, a consensus check, a no-op test
(identity explains the bridge: unify without realigning), and a Sim(3)
drift scale from depth ratios. The realignment (``apply_group_transform``)
grades the correction in se(3) over the moving group's pose rings and
keyframes since the groups separated; its owned map points take the full
correction. Map tables are pulled to the host once per attempt
(``util.to_host``); the solves run on the state's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from coslam_torch.config import SlamConfig
from coslam_torch.geometry.camera import normalize_points
from coslam_torch.geometry.hull import convex_hull, points_in_hull
from coslam_torch.geometry.pnp import ransac_pnp
from coslam_torch.geometry.se3 import orthonormalize_fast, se3_exp, se3_log
from coslam_torch.ops.matching import guided_match
from coslam_torch.ops.ncc import extract_ncc_blocks_batched
from coslam_torch.slam.state import (LONG_STRIDE, PT_DYNAMIC, PT_STATIC,
                                     ST_ALIVE, ST_FALSE, SlamState)
from coslam_torch.solvers.pose import irls_pose
from coslam_torch.solvers.pose_graph import (PoseGraph, solve_rotations,
                                             solve_translations)
from coslam_torch.spans import span
from coslam_torch.util import to_host

MAX_BRIDGE = 512     # fixed bridge capacity (pairs beyond keep the best NCC)


class MergeCandidate(NamedTuple):
    cam_a: int      # camera in the anchor group
    cam_b: int      # camera in the moving group
    overlap: int


def scan_candidates_device(state: SlamState, K: torch.Tensor, h: int, w: int,
                           dormant_age: int):
    """Small device reduction feeding the merge and loop candidate scans.
    Returns:
      merge_counts [C, C]: alive static points owned by camera j that
                           project inside camera i's image
      alive_per_owner [C]: alive static points per owner camera
      dormant_counts [C]:  dormant (unseen >= dormant_age) alive static
                           points projecting inside each camera
    ``merge_counts`` is a float32 product (TF32 stays off)."""
    mp = state.mappts
    C = state.R.shape[0]
    alive = (mp.status == ST_ALIVE) & (mp.ptype == PT_STATIC)
    Xc = torch.einsum("cij,pj->cpi", state.R, mp.xyz) + state.t[:, None, :]
    z = Xc[..., 2]
    zi = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = Xc[..., 0] * zi * K[:, 0, 0, None] + K[:, 0, 2, None]
    v = Xc[..., 1] * zi * K[:, 1, 1, None] + K[:, 1, 2, None]
    inside = alive[None] & (z > 1e-3) & (u >= 0) & (u < w) & \
        (v >= 0) & (v < h)
    own = torch.nn.functional.one_hot(
        torch.clamp(mp.owner, 0, C - 1).long(), C).to(torch.float32) \
        * alive[:, None].to(torch.float32)
    merge_counts = inside.to(torch.float32) @ own
    dormant = alive & (state.frame - mp.last_obs >= dormant_age)
    dormant_counts = torch.sum(inside & dormant[None], dim=1)
    return merge_counts, torch.sum(own, dim=0), dormant_counts


def _project_np(K, Xc):
    """Pixels of camera-frame points [M, 3] (depth floored at 1e-9)."""
    z = np.where(np.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
    return Xc[:, 0] / z * K[0, 0] + K[0, 2], Xc[:, 1] / z * K[1, 1] + K[1, 2]


def find_merge_candidates(state: SlamState, cfg: SlamConfig,
                          group_id: np.ndarray, host=None) -> list:
    """checkPossibleMergable: for cameras in different groups, the other
    group's alive static points in camera a's frame, gated on the camera
    distance against their median depth. Returns [(a, b, Xc, ok)].
    ``host``: the (status, ptype, owner, xyz, R, t) numpy tables, when the
    caller already pulled them."""
    p = cfg.p
    C = cfg.num_cameras
    mp = state.mappts
    if host is None:
        host = to_host(mp.status, mp.ptype, mp.owner, mp.xyz, state.R,
                       state.t)
    status, ptype, owner, xyz, R, t = host
    alive = (status == ST_ALIVE) & (ptype == PT_STATIC)
    centers = -np.einsum("cji,cj->ci", R, t)
    out = []
    for a in range(C):
        for b in range(C):
            if group_id[a] == group_id[b]:
                continue
            own_b = alive & (group_id[owner] == group_id[b])
            if own_b.sum() < p.merge_overlap_min:
                continue
            Xc = xyz[own_b] @ R[a].T + t[a]
            ok = Xc[:, 2] > 1e-3
            med_z = np.median(Xc[ok, 2]) if ok.any() else np.inf
            if np.linalg.norm(centers[a] - centers[b]) > \
                    p.max_dist_ratio * max(med_z, 1e-3):
                continue
            out.append((a, b, Xc, ok))
    return out


def projected_overlap(K, Xc, ok, h, w, feat_hull=None) -> int:
    """Points projecting into camera a's view; with ``feat_hull`` (a CCW
    hull of the camera's live features) the test is containment in that
    hull (checkViewOverlap's mask: projections on untracked image regions
    do not count)."""
    u, v = _project_np(K, Xc)
    inside = ok & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    if feat_hull is not None and len(feat_hull) >= 3:
        inside = inside & points_in_hull(np.stack([u, v], -1), feat_hull)
    return int(inside.sum())


def merge_candidates(state: SlamState, cfg: SlamConfig, K: np.ndarray,
                     group_id: np.ndarray) -> list[MergeCandidate]:
    """Candidate bridges, best overlap first: an absolute floor of points
    inside the viewing camera's feature hull, or a fraction of the other
    group's candidate points."""
    h, w = cfg.image_height, cfg.image_width
    mp, tr = state.mappts, state.tracks
    *host, pos, tvalid = to_host(mp.status, mp.ptype, mp.owner, mp.xyz,
                                 state.R, state.t, tr.pos, tr.valid)
    hulls = [convex_hull(pos[c][tvalid[c]]) if tvalid[c].sum() >= 3 else None
             for c in range(cfg.num_cameras)]
    cands = []
    for (a, b, Xc, ok) in find_merge_candidates(state, cfg, group_id,
                                                host=host):
        n = projected_overlap(K[a], Xc, ok, h, w, feat_hull=hulls[a])
        n_cand = int(ok.sum())
        if n >= cfg.p.merge_overlap_min or \
                (n_cand > 0 and n / n_cand >= cfg.p.merge_overlap_ratio):
            cands.append(MergeCandidate(cam_a=a, cam_b=b, overlap=n))
    cands.sort(key=lambda c: -c.overlap)
    return cands


class MergeResult(NamedTuple):
    ok: bool
    state: SlamState
    scale: float              # metric bridge-baseline length
    n_matches: int
    scale_move: float = 1.0   # moving group's estimated map-scale drift
    noop: bool = False        # merged WITHOUT realignment (identity won)


def consensus_log_scale(ratio: np.ndarray, min_members: int = 8,
                        max_width: float = 0.45) -> float | None:
    """Robust scale from depth ratios: the median of the tightest window
    of sorted log-ratios holding at least half (and >= ``min_members``)
    of the samples, if that window is at most ``max_width`` wide; None
    otherwise (a mismatched bridge has near-uniform log-ratios)."""
    ratio = ratio[np.isfinite(ratio) & (ratio > 0)]
    if len(ratio) < min_members:
        return None
    lr = np.sort(np.log(ratio))
    k = max(min_members, (len(lr) + 1) // 2)
    if len(lr) < k:
        return None
    widths = lr[k - 1:] - lr[:len(lr) - k + 1]
    i = int(np.argmin(widths))
    if float(widths[i]) > max_width:
        return None
    return float(np.exp(np.median(lr[i:i + k])))


def _relative_pose_np(R1, t1, R2, t2):
    R21 = R2 @ R1.T
    return R21, t2 - R21 @ t1


def merge_groups(state: SlamState, cfg: SlamConfig, pyr, K, kc,
                 group_id: np.ndarray, cand: MergeCandidate,
                 f_sep: int | None = None) -> MergeResult:
    """Estimate the bridge (camera b's metric pose by PnP against the
    anchor group's map), solve the camera pose graph with it, verify, and
    realign the moving group's state. ``f_sep`` = the last co-grouped
    frame: the realignment ramps from identity there to the full
    correction now. The PnP RANSAC draws from a generator seeded with the
    frame number."""
    p = cfg.p
    C = cfg.num_cameras
    a, b = cand.cam_a, cand.cam_b
    tracks, mp = state.tracks, state.mappts
    dev = tracks.pos.device
    fail = MergeResult(False, state, 1.0, 0)
    # static-only bridge: a mover crossing the shared view (what splits
    # groups in a dynamic scene) must not vote on the realignment
    mi_all = torch.clamp(tracks.mpt, min=0).long()
    mapped_dyn = (tracks.mpt >= 0) & (mp.ptype[mi_all] == PT_DYNAMIC) & \
        (mp.status[mi_all] == ST_ALIVE)
    static_feat = tracks.valid & (tracks.dyn_votes < 3) & ~mapped_dyn
    ab = [a, b]
    blocks, ok_blk = extract_ncc_blocks_batched(
        pyr.imgs[0][ab], tracks.raw[ab].contiguous(), p.ncc_patch_radius)
    # the bridging cameras look at one shared scene, so true pairs lie
    # within a bounded pixel disparity whatever the drifted poses say
    m = guided_match(blocks[0], blocks[1], ok_blk[0] & static_feat[a],
                     ok_blk[1] & static_feat[b], tracks.pos[a],
                     tracks.pos[b], F=None, min_ncc=p.ncc_min_score,
                     rounds=8, max_disparity=0.3 * cfg.image_width)
    xn_b_all = normalize_points(tracks.pos[b], K[b], kc[b])
    (sel, msc, mpt_a_all, status, ptype, owner, xyz, pos_b_all, xn_b_all,
     R, t, K_np, frame) = to_host(
        m.a_to_b, m.score, tracks.mpt[a], mp.status, mp.ptype, mp.owner,
        mp.xyz, tracks.pos[b], xn_b_all, state.R, state.t, K, state.frame)
    frame = int(frame)
    pairs = np.nonzero(sel >= 0)[0]
    if len(pairs) < 16:
        return fail._replace(n_matches=len(pairs))
    # the bridge: matched camera-a features bound to anchor-group points
    # are metric 3D anchors observed by camera b
    mpt_a = mpt_a_all[pairs]
    alive_pt = (status == ST_ALIVE) & (ptype == PT_STATIC)
    grp_owner = group_id[np.clip(owner, 0, C - 1)]
    mi = np.clip(mpt_a, 0, None)
    bound = (mpt_a >= 0) & alive_pt[mi] & (grp_owner[mi] == group_id[a])
    if int(bound.sum()) < 10:
        return fail._replace(n_matches=len(pairs))
    # fixed capacity: overflow keeps the best-scored pairs
    bidx_all = np.nonzero(bound)[0]
    if len(bidx_all) > MAX_BRIDGE:
        keep = np.sort(np.argsort(-msc[pairs[bound]])[:MAX_BRIDGE])
        bound = np.zeros_like(bound)
        bound[bidx_all[keep]] = True
    nb = int(bound.sum())
    fb = sel[pairs[bound]]                       # camera-b feature slots
    X_anchor = xyz[mpt_a[bound]]
    pos_b = pos_b_all[fb]
    pad = MAX_BRIDGE - nb

    def padded(arr, value=0.0):
        arr = np.asarray(arr, np.float32)
        out = np.pad(arr, ((0, pad),) + ((0, 0),) * (arr.ndim - 1),
                     constant_values=value)
        return torch.as_tensor(out, device=dev)

    X_pad = padded(X_anchor)
    mask_pad = torch.as_tensor(np.arange(MAX_BRIDGE) < nb, device=dev)
    fpx = float(K_np[b, 0, 0])
    # 8 px gate (wide-baseline matches against a drifted map carry ~5-10
    # px of noise); PROSAC tiers by NCC score; the current pose is not a
    # hypothesis: the bridge stays an independent measurement
    res_pnp = ransac_pnp(
        torch.Generator().manual_seed(frame), X_pad, padded(xn_b_all[fb]),
        mask_pad, num_hypotheses=1024, thresh=8.0 / fpx,
        score=padded(msc[pairs[bound]], -2.0))
    n_matches = int(res_pnp.num_inliers)
    if n_matches < 10:
        return fail._replace(n_matches=n_matches)
    pol = irls_pose(K[b], res_pnp.R, res_pnp.t, X_pad, padded(pos_b),
                    res_pnp.inliers, tau=float(p.max_err))
    R_b_pnp, t_b_pnp = to_host(pol.R, pol.t)
    fail = fail._replace(n_matches=n_matches)
    if not (np.isfinite(R_b_pnp).all() and np.isfinite(t_b_pnp).all()):
        return fail
    # pose graph: rigid chain edges inside each group from the current
    # estimates, one metric merge edge a -> b from the PnP pose; the
    # anchor group stays put
    from coslam_torch.slam.grouping import group_adjacent_pairs
    edges = [(i, j, *_relative_pose_np(R[i], t[i], R[j], t[j]))
             for i, j in group_adjacent_pairs(group_id)]
    R_ab, t_ab = _relative_pose_np(R[a], t[a], R_b_pnp, t_b_pnp)
    scale = float(np.linalg.norm(t_ab))                  # bridge baseline
    edges.append((a, b, R_ab, t_ab))
    E = len(edges)

    def T(arr, dtype=None):
        return torch.as_tensor(np.asarray(arr, dtype), device=dev)

    pg = PoseGraph(
        edge_i=T([e[0] for e in edges], np.int32),
        edge_j=T([e[1] for e in edges], np.int32),
        edge_R=T(np.stack([e[2] for e in edges]), np.float32),
        edge_t=T(np.stack([e[3] for e in edges]), np.float32),
        edge_valid=torch.ones(E, dtype=torch.bool, device=dev),
        edge_weight=torch.ones(E, dtype=torch.float32, device=dev),
        scale_group=torch.full((E,), -1, dtype=torch.int32, device=dev),
        fixed=T(group_id == group_id[a]), fixed_R=state.R, fixed_t=state.t,
        node_valid=torch.ones(C, dtype=torch.bool, device=dev))
    R_sol = solve_rotations(pg)
    t_sol, _ = solve_translations(pg, R_sol, num_scales=1)
    R_sol, t_sol = to_host(R_sol, t_sol)
    if not (np.isfinite(R_sol).all() and np.isfinite(t_sol).all()):
        return fail
    K_b = K_np[b]

    def reproj_err(R_h, t_h):
        """Per-pair error against camera b's matches (inf behind it)."""
        Xc_h = X_anchor @ R_h.T + t_h
        u_h, v_h = _project_np(K_b, Xc_h)
        e_h = np.hypot(u_h - pos_b[:, 0], v_h - pos_b[:, 1])
        return np.where(Xc_h[:, 2] > 1e-3, e_h, np.inf), Xc_h

    # verification on the solved pose's OWN consensus set (a
    # repetitive-texture bridge is mostly wrong mutual-best matches, so a
    # median over all of them rejects every working bridge)
    gate_px = float(p.pixel_err_var)
    err_v, Xc_v = reproj_err(R_sol[b], t_sol[b])
    in_sol = err_v < gate_px
    med_sol = float(np.median(err_v[in_sol])) if in_sol.sum() else np.inf
    if int(in_sol.sum()) < 8 or med_sol > gate_px:
        return fail
    # no-op: if camera b's current pose explains the bridge about as well,
    # the groups never drifted apart (an occlusion split): unify without
    # realigning, and log the baseline actually kept
    err_id, _ = reproj_err(R[b], t[b])
    in_id = err_id < gate_px
    med_id = float(np.median(err_id[in_id])) if int(in_id.sum()) >= 8 \
        else np.inf
    if med_id <= gate_px and int(in_id.sum()) >= 0.8 * int(in_sol.sum()):
        c_a = -R[a].T @ t[a]
        c_b = -R[b].T @ t[b]
        return MergeResult(True, state, float(np.linalg.norm(c_a - c_b)),
                           n_matches, scale_move=1.0, noop=True)
    # moving-group scale drift (Sim(3)): verified anchor points against the
    # moving map's points projecting onto the same camera-b pixels; their
    # depth ratio is the separated group's accumulated scale drift
    s_move = 1.0
    mov = np.nonzero(alive_pt & (grp_owner == group_id[b]))[0]
    if len(mov) >= 8:
        Xcb = xyz[mov] @ R[b].T + t[b]
        okb = Xcb[:, 2] > 1e-3
        if okb.sum() >= 8:
            zb = Xcb[okb, 2]
            ub, vb = _project_np(K_b, Xcb[okb])
            dpx = np.linalg.norm(pos_b[:, None] - np.stack([ub, vb], -1)[None],
                                 axis=-1)
            jn = dpx.argmin(1)
            okp = (dpx.min(1) < 3.0) & (Xc_v[:, 2] > 1e-3) & in_sol
            if okp.sum() >= 8:
                ratio = Xc_v[okp, 2] / np.maximum(zb[jn[okp]], 1e-6)
                s_est = consensus_log_scale(ratio, min_members=8,
                                            max_width=0.4)
                if s_est is not None and 0.4 < s_est < 2.5:
                    s_move = s_est
    # world-frame correction from camera b:
    # T_new = (R_old R_s^T, s t_old - R_new t_s)
    R_s = R_sol[b].T @ R[b]
    t_s = R_sol[b].T @ (s_move * t[b] - t_sol[b])
    state = apply_group_transform(state, cfg, group_id == group_id[b],
                                  R_s.astype(np.float32),
                                  t_s.astype(np.float32), group_id,
                                  f_sep=f_sep, scale=s_move)
    return MergeResult(True, state, scale, n_matches, scale_move=s_move)


def apply_group_transform(state: SlamState, cfg: SlamConfig,
                          move_cams: np.ndarray, R_s: np.ndarray,
                          t_s: np.ndarray, group_id: np.ndarray,
                          f_sep: int | None = None,
                          anchor_before: int | None = None,
                          scale: float = 1.0) -> SlamState:
    """Apply the world-frame correction x -> s R_s x + t_s to the moving
    cameras' state: poses T' = T o S^-1, the pose rings, keyframe poses,
    and their owned map points.

    With ``f_sep`` (the last frame the groups were co-grouped), an entity
    of frame f takes S^w with w = (f - f_sep) / (f_now - f_sep), clipped
    to [0, 1] and interpolated in se(3) (and s^w): drift accumulated
    gradually over the separation, so the correction ramps from identity
    there to S now. Owned map points take the full correction (they are
    refined against current observations, so they live at "now"); with
    ``anchor_before``, points not observed since then (the dormant map a
    loop closure anchors on) stay put."""
    dev = state.R.device
    f32 = torch.float32
    mv = torch.as_tensor(np.asarray(move_cams), device=dev)
    f_merge = int(state.frame)
    rigid = f_sep is None
    if rigid or f_merge - f_sep < 2:
        span, f0 = 1, f_merge - 1      # only current entities move
    else:
        span, f0 = f_merge - f_sep, f_sep
    xi = se3_log(torch.as_tensor(np.asarray(R_s, np.float32), device=dev),
                 torch.as_tensor(np.asarray(t_s, np.float32), device=dev))
    lam = float(np.log(max(scale, 1e-6)))

    def w_of(frames):
        if rigid:
            return torch.ones(frames.shape, dtype=f32, device=dev)
        return torch.clamp((frames.to(f32) - f0) / span, 0.0, 1.0)

    def S_at(w):
        """Graded correction (exp(w xi), s^w)."""
        Rw, tw = se3_exp(w[..., None] * xi)
        return Rw, tw, torch.exp(w * lam)

    def xf_pose(R, t, Rw, tw, sw):
        # the camera sees the same image under T' = (R Rw^T, s t - R' tw)
        Rn = orthonormalize_fast(R @ Rw.transpose(-1, -2))
        tn = sw[..., None] * t - (Rn @ tw[..., None])[..., 0]
        return Rn, tn

    def put(mask, new, old):
        return torch.where(mask.reshape(mask.shape + (1,) * (
            old.dim() - mask.dim())), new, old)

    R_full, t_full, s_full = S_at(torch.ones((), dtype=f32, device=dev))
    R_new, t_new = xf_pose(state.R, state.t, R_full, t_full,
                           s_full.expand(state.t.shape[:-1]))
    # pose-history ring: slot k holds frame f - ((f - k) mod T)
    T = state.pose_hist_R.shape[1]
    f_hist = f_merge - np.mod(f_merge - np.arange(T), T)
    Rw_h, tw_h, sw_h = S_at(w_of(torch.as_tensor(f_hist, device=dev)))
    phR, pht = xf_pose(state.pose_hist_R, state.pose_hist_t, Rw_h[None],
                       tw_h[None], sw_h[None])
    # long ring: slot k holds frame LONG_STRIDE m, m = m_cur - ((m_cur - k)
    # mod TL), m_cur = f // LONG_STRIDE
    TL = state.pose_hist_long_R.shape[1]
    m_cur = f_merge // LONG_STRIDE
    f_hist_l = LONG_STRIDE * (m_cur - np.mod(m_cur - np.arange(TL), TL))
    Rw_l, tw_l, sw_l = S_at(w_of(torch.as_tensor(f_hist_l, device=dev)))
    phRl, phtl = xf_pose(state.pose_hist_long_R, state.pose_hist_long_t,
                         Rw_l[None], tw_l[None], sw_l[None])
    # keyframes, graded by their frame stamps
    kfs = state.kfs
    Rw_k, tw_k, sw_k = S_at(w_of(kfs.frame))
    kR, kt = xf_pose(kfs.R, kfs.t, Rw_k[:, None], tw_k[:, None],
                     sw_k[:, None])
    kfs = kfs._replace(R=put(mv[None].expand(kR.shape[:2]), kR, kfs.R),
                       t=put(mv[None].expand(kt.shape[:2]), kt, kfs.t))
    mp = state.mappts
    owner_moves = mv[torch.clamp(mp.owner, 0, cfg.num_cameras - 1).long()] \
        & (mp.status == ST_ALIVE)
    if anchor_before is not None:
        owner_moves = owner_moves & (mp.last_obs >= anchor_before)
    X_new = s_full * (mp.xyz @ R_full.T) + t_full
    cov_new = (s_full * s_full) * torch.einsum("ij,pjk,lk->pil", R_full,
                                               mp.cov, R_full)
    mappts = mp._replace(xyz=put(owner_moves, X_new, mp.xyz),
                         cov=put(owner_moves, cov_new, mp.cov))
    return state._replace(
        R=put(mv, R_new, state.R), t=put(mv, t_new, state.t),
        pose_hist_R=put(mv, phR, state.pose_hist_R),
        pose_hist_t=put(mv, pht, state.pose_hist_t),
        pose_hist_long_R=put(mv, phRl, state.pose_hist_long_R),
        pose_hist_long_t=put(mv, phtl, state.pose_hist_long_t),
        kfs=kfs, mappts=mappts)


def fuse_duplicate_points(state: SlamState, cfg: SlamConfig,
                          group_id: np.ndarray, cand: MergeCandidate,
                          rel_thresh: float = 0.05) -> SlamState:
    """After a realignment, the moving group's alive static points within
    ``rel_thresh`` x owner-camera depth of an anchor-group point go false
    (checkMergeMapPoints/mergeMapPoints): their features re-register onto
    the surviving point. Nearest-neighbour search in 512-point blocks."""
    mp = state.mappts
    C = cfg.num_cameras
    status, ptype, owner, xyz, R, t = to_host(mp.status, mp.ptype, mp.owner,
                                             mp.xyz, state.R, state.t)
    alive = (status == ST_ALIVE) & (ptype == PT_STATIC)
    own_c = np.clip(owner, 0, C - 1)
    grp = group_id[own_c]
    ia = np.nonzero(alive & (grp == group_id[cand.cam_a]))[0]
    ib = np.nonzero(alive & (grp == group_id[cand.cam_b]))[0]
    if len(ia) == 0 or len(ib) == 0:
        return state
    depth = np.einsum("pj,pj->p", R[own_c][:, 2, :], xyz) + t[own_c][:, 2]
    depth = np.where(depth > 1e-3, depth, 1e-3)
    Xa, Xb = xyz[ia], xyz[ib]
    dup_mask = np.zeros(len(ib), bool)
    for s in range(0, len(ib), 512):
        d = np.linalg.norm(Xa[:, None] - Xb[None, s:s + 512], axis=-1)
        thr = rel_thresh * np.minimum(depth[ia][:, None],
                                      depth[ib[s:s + 512]][None, :])
        dup_mask[s:s + 512] = (d < thr).any(axis=0)
    dup_b = ib[dup_mask]
    if len(dup_b) == 0:
        return state
    status = mp.status.clone()
    status[torch.as_tensor(dup_b, device=status.device)] = ST_FALSE
    return state._replace(mappts=mp._replace(status=status))


def _fuse_close_kill_mask(mappts, R: torch.Tensor, t: torch.Tensor,
                          rel_thresh: float = 0.025,
                          block: int = 512) -> torch.Tensor:
    """[P] kill mask: point j dies when some strictly older (first_frame,
    then index) alive static point i sits within rel_thresh x
    min(depth_i, depth_j) of it AND their stored appearances agree (NCC >=
    0.8 in some camera both hold a block for). Blocked [block, P] sweeps."""
    P = mappts.xyz.shape[0]
    C = R.shape[0]
    dev = mappts.xyz.device
    alive = (mappts.status == ST_ALIVE) & (mappts.ptype == PT_STATIC)
    own = torch.clamp(mappts.owner, 0, C - 1).long()
    Ro = R[own]
    to = t[own]
    depth = torch.sum(Ro[:, 2, :] * mappts.xyz, -1) + to[:, 2]
    depth = torch.where(depth > 1e-3, depth, torch.full_like(depth, 1e-3))
    X = mappts.xyz
    ff = mappts.first_frame
    idx = torch.arange(P, device=dev)
    kill = torch.zeros((P,), dtype=torch.bool, device=dev)
    for s in range(0, P, block):
        e = min(s + block, P)
        Xb = X[s:e]
        d2 = sum((Xb[:, None, k] - X[None, :, k]) ** 2 for k in range(3))
        thr = rel_thresh * torch.minimum(depth[s:e, None], depth[None, :])
        close = d2 < thr * thr
        sim = torch.full((e - s, P), -float("inf"), dtype=X.dtype, device=dev)
        for c in range(C):
            simc = mappts.ncc[s:e, c] @ mappts.ncc[:, c].T
            both = mappts.ncc_valid[s:e, c, None] & \
                mappts.ncc_valid[None, :, c]
            sim = torch.maximum(sim, torch.where(both, simc,
                                                 torch.full_like(simc,
                                                                 -float("inf"))))
        gi = idx[s:e]
        older = (ff[s:e, None] < ff[None, :]) | \
            ((ff[s:e, None] == ff[None, :]) & (gi[:, None] < idx[None, :]))
        killer = close & (sim >= 0.8) & alive[s:e, None] & alive[None, :] \
            & older
        kill = kill | torch.any(killer, dim=0)
    return kill


def fuse_close_points(state: SlamState, cfg: SlamConfig):
    """Global duplicate unification (checkUnify/refineMapPoint, every 50th
    frame): the newer of two close, look-alike static points goes false;
    its features re-register onto the survivor later. Returns
    (state', number of points killed)."""
    mp = state.mappts
    kill = _fuse_close_kill_mask(mp, state.R, state.t)
    with span("engine.wait.fuse_count"):
        n = int(torch.sum(kill))
    if n == 0:
        return state, 0
    status = torch.where(kill, torch.full_like(mp.status, ST_FALSE),
                         mp.status)
    return state._replace(mappts=mp._replace(status=status)), n
