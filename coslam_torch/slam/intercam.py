"""Inter-camera collaboration: cross-camera mapping, point registration
and the joint multi-camera pose (the port of
``coslam_tpu/slam/intercam.py``).

- ``intercam_map_group`` (NewMapPtsNCC): along a camera group, match the
  unmapped current features of adjacent cameras by epipolar + NCC, chain
  the matches into multi-view tracks, triangulate, gate and mint points
  (dynamic when near a mapped dynamic feature).
- ``register_map_points`` (activeMapPointsRegister): re-acquire unseen
  alive points per camera by projection + NCC against unmapped features.
- ``joint_pose_update`` (InterCamPoseEstimator): one robust BA over all
  cameras at the current frame, static points fixed, dynamic points free.

The JAX package's dropping scatters (``.at[slot].set(mode="drop")``) go
through ``util.set_drop``; every slot written is allocated once, so no
two writes meet.
"""

from __future__ import annotations

import torch

from coslam_torch.config import SlamConfig
from coslam_torch.geometry.camera import project_points
from coslam_torch.geometry.epipolar import fundamental_from_poses
from coslam_torch.geometry.triangulate import (inv3x3_sym_ln,
                                               triangulate_multiview_ln)
from coslam_torch.ops.matching import greedy_mutual_match, guided_match
from coslam_torch.ops.ncc import NCC_INVALID, extract_ncc_blocks_batched
from coslam_torch.slam.state import (PT_DYNAMIC, PT_STATIC, ST_ALIVE,
                                     ST_FREE, MapPoints, SlamState)
from coslam_torch.slam.steps import _rank_to_index
from coslam_torch.solvers.ba import BAProblem, bundle_adjust
from coslam_torch.util import set_drop


def _alloc_slots(mappts: MapPoints, want: torch.Tensor):
    """Map slots for the ``want`` [M] flags, in order, from the free list.
    Returns (slot [M], P where not allocated; can [M])."""
    P = mappts.xyz.shape[0]
    idx_of_rank = _rank_to_index(mappts.status == ST_FREE)
    rank = torch.cumsum(want.to(torch.int64), 0) - 1
    slot = idx_of_rank[torch.clamp(rank, 0, P - 1)].long()
    can = want & (slot < P)
    return torch.where(can, slot, P), can


def intercam_map_group(state: SlamState, pyr_cur, K: torch.Tensor,
                       kc: torch.Tensor, cams: tuple, cfg: SlamConfig):
    """Multi-view inter-camera mapping over one camera group (``cams``, in
    group order). Returns (mappts', tracks', n_new)."""
    tracks, mappts = state.tracks, state.mappts
    C, N = tracks.valid.shape
    P = mappts.xyz.shape[0]
    G = len(cams)
    p = cfg.p
    dev = tracks.pos.device
    blocks_all, ok_all = extract_ncc_blocks_batched(
        pyr_cur.imgs[0], tracks.raw, p.ncc_patch_radius)
    free = [tracks.valid[c] & (tracks.mpt[c] < 0) & ok_all[c]
            & (tracks.dyn_votes[c] < 3) for c in cams]
    # adjacent-pair guided matches along the group order
    links = []
    for g in range(G - 1):
        a, b = cams[g], cams[g + 1]
        F = fundamental_from_poses(K[a], state.R[a], state.t[a],
                                   K[b], state.R[b], state.t[b])
        m = guided_match(blocks_all[a], blocks_all[b], free[g], free[g + 1],
                         tracks.pos[a], tracks.pos[b], F=F,
                         max_epi=p.max_epi_err, min_ncc=p.ncc_min_score)
        links.append(m.a_to_b.long())              # [N] -> cam b index | -1
    # chain the links into tracks, each rooted at the first group camera
    # where its feature appears: roots are features that are not the
    # target of the previous link, so every chain is minted once
    M = (G - 1) * N
    arN = torch.arange(N, device=dev)
    fidx = torch.full((G, G - 1, N), -1, dtype=torch.int64, device=dev)
    for r in range(G - 1):
        is_target = torch.zeros((N,), dtype=torch.bool, device=dev)
        if r > 0:
            lk = links[r - 1]
            is_target = set_drop(is_target, torch.where(lk >= 0, lk, N), True)
        cur = torch.where(free[r] & ~is_target & (links[r] >= 0), arN, -1)
        fidx[r, r] = cur
        for g in range(r, G - 1):
            cur = torch.where(cur >= 0, links[g][torch.clamp(cur, min=0)], -1)
            fidx[g + 1, r] = cur
    fidx = fidx.reshape(G, M)
    obs_ok = fidx >= 0
    fsl = torch.clamp(fidx, min=0)
    cam_t = torch.as_tensor(cams, device=dev)
    px = torch.stack([tracks.pos[c][fsl[g]]
                      for g, c in enumerate(cams)])       # [G, M, 2]
    Rg, tg, Kg = state.R[cam_t], state.t[cam_t], K[cam_t]
    fx, fy = Kg[:, 0, 0], Kg[:, 1, 1]
    cx, cy = Kg[:, 0, 2], Kg[:, 1, 2]
    pxT = px.permute(0, 2, 1)                              # [G, 2, M]
    xnT = torch.stack([(pxT[:, 0] - cx[:, None]) / fx[:, None],
                       (pxT[:, 1] - cy[:, None]) / fy[:, None]], dim=1)
    X_ln, _ = triangulate_multiview_ln(Rg, tg, xnT, obs_ok)   # [3, M]
    dt = X_ln.dtype
    zero = torch.zeros((M,), dtype=dt, device=dev)
    max_err = zero
    depth_ok = torch.ones((M,), dtype=torch.bool, device=dev)
    Hpx = [[torch.full((M,), 1e-9 if i == j else 0.0, dtype=dt, device=dev)
            for j in range(3)] for i in range(3)]
    for g in range(G):
        R, t = Rg[g], tg[g]
        Xc = [R[i, 0] * X_ln[0] + R[i, 1] * X_ln[1] + R[i, 2] * X_ln[2]
              + t[i] for i in range(3)]
        z = Xc[2]
        zi = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9),
                               z)
        u = fx[g] * Xc[0] * zi + cx[g]
        v = fy[g] * Xc[1] * zi + cy[g]
        e = torch.hypot(u - pxT[g, 0], v - pxT[g, 1])
        max_err = torch.maximum(max_err, torch.where(obs_ok[g], e, zero))
        depth_ok = depth_ok & torch.where(obs_ok[g], z > 1e-3, True)
        xz = Xc[0] * zi
        yz = Xc[1] * zi
        Ju = [fx[g] * (R[0, j] - xz * R[2, j]) * zi for j in range(3)]
        Jv = [fy[g] * (R[1, j] - yz * R[2, j]) * zi for j in range(3)]
        w = obs_ok[g].to(dt)
        for i in range(3):
            for j in range(i + 1):
                Hpx[i][j] = Hpx[i][j] + w * (Ju[i] * Ju[j] + Jv[i] * Jv[j])
    # parallax: widest angle between the point->camera-centre directions
    centers = -torch.einsum("gji,gj->gi", Rg, tg)          # [G, 3]
    dirs = []
    for g in range(G):
        d = [X_ln[i] - centers[g, i] for i in range(3)]
        nrm = torch.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2 + 1e-18)
        dirs.append([d[i] / nrm for i in range(3)])
    min_cos = torch.ones((M,), dtype=dt, device=dev)
    one = torch.ones((M,), dtype=dt, device=dev)
    for g1 in range(G):
        for g2 in range(g1 + 1, G):
            cth = torch.abs(sum(dirs[g1][i] * dirs[g2][i] for i in range(3)))
            both = obs_ok[g1] & obs_ok[g2]
            min_cos = torch.minimum(min_cos, torch.where(both, cth, one))
    max_cos = torch.cos(torch.deg2rad(torch.tensor(
        p.new_point_min_parallax_deg, dtype=dt))).to(dev)
    fin = torch.isfinite(X_ln[0]) & torch.isfinite(X_ln[1]) & \
        torch.isfinite(X_ln[2])
    good = (torch.sum(obs_ok, dim=0) >= 2) & depth_ok & fin & \
        (max_err < p.reproj_new_point_gate) & (min_cos < max_cos)
    # decidePointType: within a Chebyshev square of a feature bound to a
    # MAPPED dynamic point in any observing view, the new point belongs to
    # the moving object (vote-only dynamic features do not mask)
    near_dyn = torch.zeros((M,), dtype=torch.bool, device=dev)
    for g, c in enumerate(cams):
        mic = torch.clamp(tracks.mpt[c], min=0).long()
        dyn_feat = tracks.valid[c] & (tracks.mpt[c] >= 0) & \
            (mappts.status[mic] == ST_ALIVE) & \
            (mappts.ptype[mic] == PT_DYNAMIC)
        dch = torch.maximum(
            torch.abs(px[g][:, None, 0] - tracks.pos[c][None, :, 0]),
            torch.abs(px[g][:, None, 1] - tracks.pos[c][None, :, 1]))
        dmin = torch.amin(torch.where(dyn_feat[None, :], dch,
                                      torch.full_like(dch, torch.inf)), dim=1)
        near_dyn = near_dyn | (obs_ok[g] & (dmin <= p.dyn_neighborhood_px))
    # allocate + write
    slot, can = _alloc_slots(mappts, good)
    Hinv = inv3x3_sym_ln(Hpx)
    covs = torch.stack([torch.stack(row) for row in Hinv]) \
        .permute(2, 0, 1) * p.pixel_err_var                 # [M, 3, 3]
    i32 = torch.int32
    owner_m = cam_t[:G - 1].to(i32).repeat_interleave(N)
    ptype_new = torch.where(near_dyn, PT_DYNAMIC, PT_STATIC).to(i32)
    frame = state.frame
    mp = mappts._replace(
        xyz=set_drop(mappts.xyz, slot, X_ln.T),
        cov=set_drop(mappts.cov, slot, covs),
        gen=set_drop(mappts.gen, slot, torch.ones_like(slot, dtype=i32),
                     accumulate=True),
        status=set_drop(mappts.status, slot, ST_ALIVE),
        ptype=set_drop(mappts.ptype, slot, ptype_new),
        first_frame=set_drop(mappts.first_frame, slot, frame),
        last_obs=set_drop(mappts.last_obs, slot, frame),
        bad_votes=set_drop(mappts.bad_votes, slot, 0),
        moved_votes=set_drop(mappts.moved_votes, slot, 0),
        owner=set_drop(mappts.owner, slot, owner_m))
    mpt_rows = list(tracks.mpt.unbind(0))
    ncc, ncc_valid = mp.ncc, mp.ncc_valid
    for g, c in enumerate(cams):
        use = obs_ok[g] & can
        mpt_rows[c] = set_drop(mpt_rows[c], torch.where(use, fsl[g], N),
                               slot.to(i32))
        pslot = torch.where(use, slot, P)
        cidx = torch.full_like(pslot, c)
        ncc = set_drop(ncc, (pslot, cidx), blocks_all[c][fsl[g]])
        ncc_valid = set_drop(ncc_valid, (pslot, cidx), ok_all[c][fsl[g]])
    mp = mp._replace(ncc=ncc, ncc_valid=ncc_valid)
    return mp, tracks._replace(mpt=torch.stack(mpt_rows)), torch.sum(can)


def register_map_points(state: SlamState, pyr_cur, K: torch.Tensor,
                        cfg: SlamConfig, max_age: int):
    """Re-acquire unseen alive static points, last observed at most
    ``max_age`` frames ago, per camera by projection + NCC: an unmapped
    feature binds to a point of its own camera group whose projection lies
    within 3 sigma and whose stored appearance matches (mutual best,
    NCC >= ncc_min_score). Returns (state', n_new).

    The score matrix is a float32 product on every device: the JAX package
    asks for ``Precision.DEFAULT`` there, which is bf16 on a TPU and f32 on
    its CPU. The reference's ``gate_scale``/``min_age``/``steal_young``/
    ``min_score`` options serve group merge and loop closure (ROADMAP A14)
    and come with them."""
    tracks, mappts = state.tracks, state.mappts
    C, N = tracks.valid.shape
    P = mappts.xyz.shape[0]
    p = cfg.p
    dev = tracks.pos.device
    gate = (p.pixel_err_var ** 0.5) * 3.0
    alive = (mappts.status == ST_ALIVE) & (mappts.ptype == PT_STATIC) & \
        (state.frame - mappts.last_obs <= max_age)
    # registration stays within the camera group
    owner_grp = state.group_id[torch.clamp(mappts.owner, 0, C - 1).long()]
    blocks_all, ok_all = extract_ncc_blocks_batched(
        pyr_cur.imgs[0], tracks.raw, p.ncc_patch_radius)
    ar_p = torch.arange(P, device=dev, dtype=torch.int32)
    mpt_rows = list(tracks.mpt.unbind(0))
    n_new = torch.zeros((), dtype=torch.int64, device=dev)
    for c in range(C):
        mpt_c = mpt_rows[c]
        seen = set_drop(torch.zeros((P,), dtype=torch.bool, device=dev),
                        torch.where(tracks.valid[c] & (mpt_c >= 0), mpt_c, P),
                        True)
        cand_p = alive & ~seen & mappts.ncc_valid[:, c] & \
            (owner_grp == state.group_id[c])
        pr = project_points(K[c], state.R[c], state.t[c], mappts.xyz)
        free_f = tracks.valid[c] & (mpt_c < 0) & ok_all[c]
        s = mappts.ncc[:, c] @ blocks_all[c].T                 # [P, N]
        dist = torch.linalg.norm(pr[:, None, :] - tracks.pos[c][None], dim=-1)
        bad = ~(cand_p[:, None] & free_f[None, :]) | (dist > gate)
        s = torch.where(bad, torch.full_like(s, NCC_INVALID), s)
        mres = greedy_mutual_match(s, min_score=p.ncc_min_score, rounds=4)
        got = mres.a_to_b >= 0                                 # [P]
        mpt_rows[c] = set_drop(mpt_c, torch.where(got, mres.a_to_b, N), ar_p)
        n_new = n_new + torch.sum(got)
    return state._replace(tracks=tracks._replace(
        mpt=torch.stack(mpt_rows))), n_new


def joint_pose_update(state: SlamState, K: torch.Tensor, cfg: SlamConfig):
    """InterCamPoseEstimator: one robust BA over all cameras at the current
    frame: static points fixed (every mapped static feature), dynamic
    points free with all their current views (structure help), at most
    ``dyn_max_points`` of them. Returns (R, t); the old pose where the
    solve is not finite."""
    tracks, mappts = state.tracks, state.mappts
    C, N = tracks.valid.shape
    P = mappts.xyz.shape[0]
    p = cfg.p
    dev = tracks.pos.device
    mi = torch.clamp(tracks.mpt, min=0).long()
    mapped = tracks.valid & (tracks.mpt >= 0) & \
        (mappts.status[mi] == ST_ALIVE)
    is_static = mapped & (mappts.ptype[mi] == PT_STATIC)
    is_dyn = mapped & (mappts.ptype[mi] == PT_DYNAMIC)
    dyn_pt = set_drop(torch.zeros((P,), dtype=torch.bool, device=dev),
                      torch.where(is_dyn, tracks.mpt, P).reshape(-1), True)
    dyn_rank = torch.cumsum(dyn_pt.to(torch.int64), 0) - 1
    dyn_pt = dyn_pt & (dyn_rank < p.dyn_max_points)
    is_dyn = is_dyn & dyn_pt[mi]
    prob = BAProblem(
        K=K, R=state.R, t=state.t, X=mappts.xyz,
        obs_cam=torch.arange(C, device=dev)[:, None].expand(C, N)
        .reshape(-1),
        obs_pt=mi.reshape(-1), obs_px=tracks.pos.reshape(C * N, 2),
        obs_valid=(is_static | is_dyn).reshape(-1),
        cam_fixed=torch.zeros((C,), dtype=torch.bool, device=dev),
        point_fixed=~dyn_pt)          # static structure fixed, dynamic free
    res = bundle_adjust(prob, max_err=p.max_err, max_iter=3, inner_iter=15)
    ok = torch.all(torch.isfinite(res.R)) & torch.all(torch.isfinite(res.t))
    return torch.where(ok, res.R, state.R), torch.where(ok, res.t, state.t)
