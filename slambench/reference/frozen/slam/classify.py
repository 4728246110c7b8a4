"""Static/dynamic/false/uncertain map-point classification and dynamic
feature detection (the port of ``coslam_tpu/slam/classify.py``).

- ``detect_dynamic_features``: per-feature epipolar voting over the track
  history (detectDynamicFeaturePoints): a feature on a static point must
  satisfy the epipolar constraint against its past poses; persistent
  violations vote it dynamic.
- ``classify_map_points``: the mapPointsClassify state machine over the
  whole map: multi-view re-triangulation from the current frame,
  reprojection gating of every view, the stored-position consistency
  test over the frame window, the drop-one-view rescue, moved-vs-stored
  static/dynamic decision, and persistent inconsistency -> false.
  Dynamic points take the current triangulation every frame.

Everything runs batched over the [P] map and the [C, T, N] history;
per-point 3-vectors and 3x3 blocks are lists of [P] tensors, as in the
JAX package. The per-feature window counts reach their points by
``index_add_`` (integer sums, so the order does not matter).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slambench.reference.frozen.config import SlamConfig
from slambench.reference.frozen.geometry.epipolar import fundamental_from_poses
from slambench.reference.frozen.geometry.triangulate import (inv3x3_sym_ln,
                                               triangulate_multiview_ln)
from slambench.reference.frozen.slam.state import (LONG_STRIDE, PT_DYNAMIC, PT_STATIC,
                                     PT_UNCERTAIN, ST_ALIVE, ST_FALSE,
                                     MapPoints, SlamState)
from slambench.reference.frozen.util import set_drop


def point_obs_table(tracks, P: int):
    """Invert the track->map binding: returns (slot [P, C] feature index or
    -1, obs_px [P, C, 2], obs_ok [P, C]) — the MapPoint::pFeatures view."""
    C, N = tracks.valid.shape
    dev = tracks.valid.device
    mapped = tracks.valid & (tracks.mpt >= 0)
    tgt = torch.where(mapped, tracks.mpt, P)            # P = dropped
    cam_ids = torch.arange(C, device=dev)[:, None].expand(C, N)
    feat_ids = torch.arange(N, device=dev, dtype=torch.int32)[None, :] \
        .expand(C, N)
    slot = torch.full((P, C), -1, dtype=torch.int32, device=dev)
    slot = set_drop(slot, (tgt, cam_ids), feat_ids)
    obs_ok = slot >= 0
    sl = torch.clamp(slot, min=0).long()
    obs_px = tracks.pos[torch.arange(C, device=dev)[None, :], sl]  # [P,C,2]
    return slot, obs_px, obs_ok


def _safe_inv(z):
    return 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def detect_dynamic_features(state: SlamState, K: torch.Tensor,
                            cfg: SlamConfig) -> SlamState:
    """Epipolar voting over the rolling history. Returns the state with
    ``tracks.dyn_votes`` incremented where a feature violates the
    static-world epipolar constraint against most of its past poses
    (decremented otherwise, zeroed on invalid slots)."""
    tracks = state.tracks
    C, T, N = tracks.hist_valid.shape
    p = cfg.p
    dev = tracks.pos.device
    k_off = torch.arange(T, device=dev)
    past_frame = state.frame - k_off
    ring = torch.remainder(past_frame, T).long()
    hist_pos = tracks.hist.index_select(1, ring)                  # [C,T,N,2]
    ages = torch.clamp(tracks.age - 1, max=T - 1)
    hist_ok = tracks.hist_valid.index_select(1, ring) & \
        (k_off[None, :, None] >= 2) & \
        (k_off[None, :, None] <= ages[:, None]) & \
        (past_frame[None, :, None] >= 0)
    Rp = state.pose_hist_R.index_select(1, ring)                  # [C,T,3,3]
    tp = state.pose_hist_t.index_select(1, ring)
    # F from each past pose to the current one, pixel space: [C, T, 3, 3]
    F = fundamental_from_poses(K[:, None], Rp, tp, K[:, None],
                               state.R[:, None], state.t[:, None])
    x1 = torch.cat([hist_pos, torch.ones_like(hist_pos[..., :1])], -1)
    x2 = torch.cat([tracks.pos, torch.ones_like(tracks.pos[..., :1])], -1)
    l2 = torch.einsum("ctij,ctnj->ctni", F, x1)         # lines in current
    num = torch.abs(torch.einsum("ctni,cni->ctn", l2, x2))
    den = torch.clamp(torch.linalg.norm(l2[..., :2], dim=-1), min=1e-9)
    viol = hist_ok & (num / den > p.max_epi_err)
    n_checks = torch.sum(hist_ok, dim=1)
    n_viol = torch.sum(viol, dim=1)
    # voted dynamic this frame: >= 50% of >= 3 history checks violate
    vote = (n_checks >= 3) & (n_viol * 2 > n_checks)
    votes = torch.where(vote, tracks.dyn_votes + 1,
                        torch.clamp(tracks.dyn_votes - 1, min=0))
    votes = torch.where(tracks.valid, votes, torch.zeros_like(votes))
    return state._replace(tracks=tracks._replace(dyn_votes=votes))


class ClassifyOut(NamedTuple):
    mappts: MapPoints
    n_static: torch.Tensor
    n_dynamic: torch.Tensor
    n_false: torch.Tensor
    tracks: object = None   # TrackTable with outlier views detached


def _window_counts(Xs, hpos, ok, Rp, tp, K, c, gate):
    """ok/good counts [N] of camera c's [T', N] history block against the
    stored positions Xs (3 x [N]). A historic frame where most checks fail
    is a glitched historic pose, not motion: it is dropped from both
    counts (a real mover fails only its own checks)."""
    Xc = [Rp[:, i, 0, None] * Xs[0][None] + Rp[:, i, 1, None] * Xs[1][None]
          + Rp[:, i, 2, None] * Xs[2][None] + tp[:, i, None]
          for i in range(3)]                                  # 3 x [T', N]
    z = Xc[2]
    zi = _safe_inv(z)
    du = K[c, 0, 0] * Xc[0] * zi + K[c, 0, 2] - hpos[:, :, 0]
    dv = K[c, 1, 1] * Xc[1] * zi + K[c, 1, 2] - hpos[:, :, 1]
    e2 = du * du + dv * dv
    good = ok & (z > 1e-3) & (e2 < gate * gate)
    tot_ok = torch.sum(ok, dim=1, dtype=torch.int32)
    tot_good = torch.sum(good, dim=1, dtype=torch.int32)
    reliable = ((tot_ok < 8) | (2 * tot_good >= tot_ok))[:, None]
    return (torch.sum(ok & reliable, dim=0, dtype=torch.int32),
            torch.sum(good & reliable, dim=0, dtype=torch.int32))


def _windowed_static_err(state: SlamState, K: torch.Tensor, cfg: SlamConfig):
    """The isStaticPoint frame-window test: reproject each point's STORED
    position against its feature's history at the historic poses over the
    last ``classify_frame_window`` frames: every frame of the dense ring,
    then the long ring (every LONG_STRIDE frames) out to the whole window.
    Returns (n_checks [P], n_consistent [P]) as int32."""
    tracks, mappts = state.tracks, state.mappts
    C, T, N = tracks.hist_valid.shape
    TL = tracks.hist_long_valid.shape[1]
    P = mappts.xyz.shape[0]
    W = cfg.p.classify_frame_window
    gate = cfg.p.max_epi_err
    frame = state.frame
    dev = tracks.pos.device
    k_off = torch.arange(T, device=dev)
    past_frame = frame - k_off
    ring = torch.remainder(past_frame, T).long()
    in_win = (k_off >= 1) & (k_off <= min(W, T - 1))
    m_off = torch.arange(TL, device=dev)
    past_m = torch.div(frame, LONG_STRIDE, rounding_mode="floor") - m_off
    ring_l = torch.remainder(past_m, TL).long()
    past_frame_l = past_m * LONG_STRIDE
    k_l = frame - past_frame_l
    in_win_l = (k_l > T - 1) & (k_l <= W) & (past_frame_l >= 0)
    n_checks = torch.zeros((P + 1,), dtype=torch.int32, device=dev)
    n_cons = torch.zeros((P + 1,), dtype=torch.int32, device=dev)
    for c in range(C):
        bound = tracks.valid[c] & (tracks.mpt[c] >= 0)
        Xf = mappts.xyz[torch.clamp(tracks.mpt[c], min=0).long()]   # [N, 3]
        Xs = [Xf[:, i] for i in range(3)]
        ages = tracks.age[c] - 1
        ok = tracks.hist_valid[c].index_select(0, ring) & bound[None] & \
            in_win[:, None] & (k_off[:, None] <= ages[None]) & \
            (past_frame[:, None] >= 0)
        nc, ng = _window_counts(
            Xs, tracks.hist[c].index_select(0, ring), ok,
            state.pose_hist_R[c].index_select(0, ring),
            state.pose_hist_t[c].index_select(0, ring), K, c, gate)
        if W > T - 1:
            ok_l = tracks.hist_long_valid[c].index_select(0, ring_l) & \
                bound[None] & in_win_l[:, None] & (k_l[:, None] <= ages[None])
            nc2, ng2 = _window_counts(
                Xs, tracks.hist_long[c].index_select(0, ring_l), ok_l,
                state.pose_hist_long_R[c].index_select(0, ring_l),
                state.pose_hist_long_t[c].index_select(0, ring_l), K, c,
                gate)
            nc, ng = nc + nc2, ng + ng2
        tgt = torch.where(bound, tracks.mpt[c], P).long()
        n_checks.index_add_(0, tgt, nc)
        n_cons.index_add_(0, tgt, ng)
    return n_checks[:P], n_cons[:P]


def _reproject_views(R, t, K, X, pxT, okT, cams, dt):
    """Max reprojection error [P] and positive depth in every observing
    view of ``cams`` for the points X (3 x [P])."""
    P = X[0].shape[0]
    max_e = torch.zeros((P,), dtype=dt, device=X[0].device)
    dok = torch.ones((P,), dtype=torch.bool, device=X[0].device)
    for c in cams:
        Xc = [R[c, i, 0] * X[0] + R[c, i, 1] * X[1] + R[c, i, 2] * X[2]
              + t[c, i] for i in range(3)]
        zi = _safe_inv(Xc[2])
        u = K[c, 0, 0] * Xc[0] * zi + K[c, 0, 2]
        v = K[c, 1, 1] * Xc[1] * zi + K[c, 1, 2]
        e = torch.hypot(u - pxT[c, 0], v - pxT[c, 1])
        max_e = torch.maximum(max_e, torch.where(okT[c], e,
                                                 torch.zeros_like(e)))
        dok = dok & torch.where(okT[c], Xc[2] > 1e-3, True)
    return max_e, dok


def classify_map_points(state: SlamState, K: torch.Tensor,
                        cfg: SlamConfig) -> ClassifyOut:
    """The mapPointsClassify state machine over the whole map."""
    tracks, mappts = state.tracks, state.mappts
    C, N = tracks.valid.shape
    P = mappts.xyz.shape[0]
    p = cfg.p
    dev = tracks.pos.device
    R, t = state.R, state.t
    alive = mappts.status == ST_ALIVE
    slot, obs_px, obs_ok = point_obs_table(tracks, P)
    nv = torch.sum(obs_ok, dim=1)                               # [P]
    pxT = obs_px.permute(1, 2, 0)                               # [C, 2, P]
    okT = obs_ok.T                                              # [C, P]
    fx, fy = K[:, 0, 0], K[:, 1, 1]
    cx, cy = K[:, 0, 2], K[:, 1, 2]
    xnT = torch.stack([(pxT[:, 0] - cx[:, None]) / fx[:, None],
                       (pxT[:, 1] - cy[:, None]) / fy[:, None]], dim=1)
    # current-frame multi-view re-triangulation (isDynamicPoint test)
    X_ln, _ = triangulate_multiview_ln(R, t, xnT, okT)          # [3, P]
    dt = X_ln.dtype
    Xs_ln = mappts.xyz.T                                        # stored
    max_err = torch.zeros((P,), dtype=dt, device=dev)
    max_err_stored = torch.zeros((P,), dtype=dt, device=dev)
    es_all = []            # per-view stored-position errors (drop-one)
    depth_ok = torch.ones((P,), dtype=torch.bool, device=dev)
    Hpx = [[torch.full((P,), 1e-9 if i == j else 0.0, dtype=dt, device=dev)
            for j in range(3)] for i in range(3)]
    zero = torch.zeros((P,), dtype=dt, device=dev)
    for c in range(C):
        Rc, tc = R[c], t[c]
        Xc = [Rc[i, 0] * X_ln[0] + Rc[i, 1] * X_ln[1] + Rc[i, 2] * X_ln[2]
              + tc[i] for i in range(3)]
        z = Xc[2]
        zi = _safe_inv(z)
        u = fx[c] * Xc[0] * zi + cx[c]
        v = fy[c] * Xc[1] * zi + cy[c]
        e = torch.hypot(u - pxT[c, 0], v - pxT[c, 1])
        max_err = torch.maximum(max_err, torch.where(okT[c], e, zero))
        depth_ok = depth_ok & torch.where(okT[c], z > 1e-3, True)
        # the STORED position against the current observations (the
        # isStaticPoint consistency test): a moving point's stored position
        # goes stale in pixels within a few frames, scale-free
        Xcs = [Rc[i, 0] * Xs_ln[0] + Rc[i, 1] * Xs_ln[1]
               + Rc[i, 2] * Xs_ln[2] + tc[i] for i in range(3)]
        zsi = _safe_inv(Xcs[2])
        us = fx[c] * Xcs[0] * zsi + cx[c]
        vs = fy[c] * Xcs[1] * zsi + cy[c]
        es = torch.where(okT[c], torch.hypot(us - pxT[c, 0],
                                             vs - pxT[c, 1]), zero)
        es_all.append(es)
        max_err_stored = torch.maximum(max_err_stored, es)
        # pixel-space projection Jacobian rows (dynamic-point covariance)
        xz = Xc[0] * zi
        yz = Xc[1] * zi
        Ju = [fx[c] * (Rc[0, j] - xz * Rc[2, j]) * zi for j in range(3)]
        Jv = [fy[c] * (Rc[1, j] - yz * Rc[2, j]) * zi for j in range(3)]
        w = okT[c].to(dt)
        for i in range(3):
            for j in range(i + 1):
                Hpx[i][j] = Hpx[i][j] + w * (Ju[i] * Ju[j] + Jv[i] * Jv[j])
    X_cur = X_ln.T                                              # [P, 3]
    tri_ok = (nv >= 2) & depth_ok & (max_err < p.max_err) & \
        torch.all(torch.isfinite(X_cur), dim=1)
    is_staticp = mappts.ptype == PT_STATIC
    # the N-frame static-consistency window, as a fraction (one glitched
    # historic pose must not condemn the map)
    n_chk, n_con = _windowed_static_err(state, K, cfg)
    win_fail = alive & is_staticp & (n_chk >= 4) & \
        (n_con.to(dt) < 0.75 * n_chk.to(dt))
    # isStaticRemovable: a failing static point with >= 3 views may be
    # corrupted by ONE view; only the worst stored-reprojection view may be
    # dropped, and only when every other view still explains the stored
    # position (a mover makes every view's stored error large)
    es_stack = torch.stack(es_all)                              # [C, P]
    neg_inf = torch.full_like(es_stack, -torch.inf)
    es_masked = torch.where(okT, es_stack, neg_inf)
    worst_view = torch.argmax(es_masked, dim=0)
    cam_axis = torch.arange(C, device=dev)
    es_rest = torch.where(cam_axis[:, None] == worst_view[None, :], neg_inf,
                          es_masked)
    one_view_bad = torch.amax(es_rest, dim=0) < p.max_epi_err
    suspect = alive & is_staticp & (nv >= 3) & (win_fail | ~tri_ok) & \
        one_view_bad
    save_any = torch.zeros((P,), dtype=torch.bool, device=dev)
    detach_cam = torch.zeros((P,), dtype=torch.int64, device=dev)
    X_saved = [zero] * 3
    for cdrop in range(C):
        okT_wo = okT & (cam_axis != cdrop)[:, None]
        X_wo, _ = triangulate_multiview_ln(R, t, xnT, okT_wo)
        max_e, dok = _reproject_views(
            R, t, K, X_wo, pxT, okT_wo,
            [c for c in range(C) if c != cdrop], dt)
        fin = torch.isfinite(X_wo[0]) & torch.isfinite(X_wo[1]) & \
            torch.isfinite(X_wo[2])
        new_save = suspect & okT[cdrop] & (worst_view == cdrop) & dok & \
            (max_e < p.max_err) & fin & ~save_any
        detach_cam = torch.where(new_save, cdrop, detach_cam)
        X_saved = [torch.where(new_save, X_wo[i], X_saved[i])
                   for i in range(3)]
        save_any = save_any | new_save
    saved = save_any
    win_fail = win_fail & ~saved
    # detach the outlier view's feature from a saved point and drop the
    # point's stored appearance for that camera
    mpt_rows = []
    nccv = mappts.ncc_valid.clone()
    for c in range(C):
        det = saved & (detach_cam == c) & (slot[:, c] >= 0)
        fidx = torch.where(det, torch.clamp(slot[:, c], min=0), N)
        mpt_rows.append(set_drop(tracks.mpt[c], fidx, -1))
        nccv[:, c] = nccv[:, c] & ~det
    tracks_out = tracks._replace(mpt=torch.stack(mpt_rows))
    mappts = mappts._replace(ncc_valid=nccv)
    # moved test: the current observations re-triangulate consistently
    # (tri_ok) but the stored position no longer explains them; two
    # consecutive moved frames flip a point (pose glitches also move it)
    moved_now = max_err_stored > p.max_epi_err
    mv = torch.where(alive & tri_ok,
                     torch.where(moved_now, mappts.moved_votes + 1,
                                 torch.zeros_like(mappts.moved_votes)),
                     mappts.moved_votes)
    mv = torch.where(saved, torch.zeros_like(mv), mv)
    moved = mv >= 2
    # feature-level dynamic votes: any bound feature voted dynamic
    dyn_feat = tracks.valid & (tracks.mpt >= 0) & (tracks.dyn_votes >= 3)
    feat_dyn = set_drop(torch.zeros((P,), dtype=torch.bool, device=dev),
                        torch.where(dyn_feat, tracks.mpt, P).reshape(-1),
                        True)
    is_dynamic = alive & tri_ok & (moved | feat_dyn)
    is_static_ok = alive & tri_ok & ~moved & ~feat_dyn & ~win_fail
    is_incons = (alive & (nv >= 2) & ~tri_ok & ~saved) | \
        (win_fail & ~is_dynamic)
    # single-view points with dynamic-voting features become uncertain
    single_dyn = alive & (nv < 2) & feat_dyn
    ptype = mappts.ptype
    ptype = torch.where(is_dynamic, PT_DYNAMIC, ptype)
    # once dynamic, a point stays dynamic; consistently static uncertain
    # points are re-promoted
    ptype = torch.where(is_static_ok & (ptype == PT_UNCERTAIN), PT_STATIC,
                        ptype)
    ptype = torch.where(single_dyn & (ptype == PT_STATIC), PT_UNCERTAIN,
                        ptype)
    # dynamic points take the current triangulation every consistent frame
    # (updateDynamicPointPosition); saved points the drop-one-view one
    upd_pos = alive & tri_ok & (is_dynamic | (ptype == PT_DYNAMIC))
    xyz = torch.where(upd_pos[:, None], X_cur, mappts.xyz)
    xyz = torch.where((saved & ~upd_pos)[:, None],
                      torch.stack(X_saved, dim=-1), xyz)
    Hinv = inv3x3_sym_ln(Hpx)
    cov_dyn = torch.stack([torch.stack(r) for r in Hinv]) * p.pixel_err_var
    cov = torch.where(upd_pos[:, None, None], cov_dyn.permute(2, 0, 1),
                      mappts.cov)
    # persistent inconsistency -> false (the setFalse path)
    bad = torch.where(is_incons, mappts.bad_votes + 1,
                      torch.where(is_static_ok | is_dynamic | saved,
                                  torch.zeros_like(mappts.bad_votes),
                                  mappts.bad_votes))
    status = torch.where(alive & (bad >= 3), ST_FALSE, mappts.status)
    mappts = mappts._replace(xyz=xyz, cov=cov, ptype=ptype.to(torch.int32),
                             status=status.to(torch.int32), bad_votes=bad,
                             moved_votes=mv)
    live = mappts.status == ST_ALIVE
    return ClassifyOut(
        mappts=mappts, n_static=torch.sum(live & (ptype == PT_STATIC)),
        n_dynamic=torch.sum(live & (ptype == PT_DYNAMIC)),
        n_false=torch.sum(status == ST_FALSE), tracks=tracks_out)
