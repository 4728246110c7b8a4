"""Multi-camera map initialization at frame 0 (the port of
``coslam_tpu/slam/initmap.py``; initMapMultiCam).

Corner NCC blocks per camera, pairwise NCC matching under a disparity
bound verified by F-RANSAC, a camera order that follows the strongest
pairs, multi-view track chaining, the E-matrix seed pair, the remaining
cameras posed by IRLS PnP from the best-connected posed camera,
multi-view triangulation, a robust BA over all cameras, and a gated
commit. Score matrices, RANSAC and solves run on the device; the chain
and ordering logic is host numpy. RANSAC samples come from CPU
``torch.Generator`` objects seeded with the integers the JAX package
gives ``jax.random.PRNGKey``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from coslam_torch.config import SlamConfig
from coslam_torch.geometry import camera as cam
from coslam_torch.geometry import epipolar
from coslam_torch.geometry.triangulate import (triangulate_multiview,
                                               triangulate_two_view_midpoint,
                                               triangulation_cov)
from coslam_torch.ops.matching import guided_match
from coslam_torch.ops.ncc import extract_ncc_blocks
from coslam_torch.solvers.ba import BAProblem, bundle_adjust
from coslam_torch.solvers.pose import irls_pose
from coslam_torch.util import nanmedian


class InitMapResult(NamedTuple):
    ok: bool
    Rs: np.ndarray          # [C, 3, 3]
    ts: np.ndarray          # [C, 3]
    X: np.ndarray           # [M, 3] world points
    cov: np.ndarray         # [M, 3, 3]
    obs_slot: np.ndarray    # [M, C] feature slot per camera, -1 = none
    cam_order: list[int]


def _pairwise_matches(cfg: SlamConfig, K, kc, pos, at, valid, blocks,
                      blk_ok):
    """NCC + F-RANSAC verified matches for every camera pair; ``at`` [C,
    N, 2] are the pixels that ``kc`` undistorts. Returns
    ({(i, j): a_to_b [N] numpy, slot of camera j matched to slot of
    camera i or -1}, counts [C, C])."""
    C, N = valid.shape
    p = cfg.p
    dev = pos.device
    out = {}
    counts = np.zeros((C, C), int)
    max_disp = 0.6 * max(cfg.image_width, cfg.image_height)
    for i in range(C):
        for j in range(i + 1, C):
            m = guided_match(blocks[i], blocks[j], blk_ok[i] & valid[i],
                             blk_ok[j] & valid[j], pos[i], pos[j], F=None,
                             min_ncc=p.ncc_min_score, max_disparity=max_disp,
                             rounds=8)
            a_to_b = m.a_to_b.cpu().numpy().astype(int)
            sel = a_to_b >= 0
            if sel.sum() >= 16:
                # F-RANSAC verification on normalized coordinates, padded
                # to N rows as the JAX package pads its static shapes
                pair_a = np.nonzero(sel)[0]
                xa = cam.normalize_points(at[i], K[i], kc[i])
                xb = cam.normalize_points(at[j], K[j], kc[j])
                x1 = torch.zeros((N, 2), dtype=xa.dtype, device=dev)
                x2 = torch.zeros_like(x1)
                n = len(pair_a)
                x1[:n] = xa[torch.as_tensor(pair_a, device=dev)]
                x2[:n] = xb[torch.as_tensor(a_to_b[pair_a], device=dev)]
                maskp = torch.zeros((N,), dtype=torch.bool, device=dev)
                maskp[:n] = True
                res = epipolar.ransac_fundamental(
                    torch.Generator().manual_seed(17 * i + j), x1, x2, maskp,
                    num_hypotheses=256, thresh=3e-5)
                inl = res.inliers[:n].cpu().numpy()
                a_to_b2 = np.full(N, -1, int)
                a_to_b2[pair_a[inl]] = a_to_b[pair_a[inl]]
                a_to_b = a_to_b2
            else:
                a_to_b = np.full(N, -1, int)
            out[(i, j)] = a_to_b
            counts[i, j] = counts[j, i] = (a_to_b >= 0).sum()
    return out, counts


def _camera_order(counts: np.ndarray) -> list[int]:
    """Greedy path through the cameras maximizing adjacent match counts
    (selectCameraOrder)."""
    C = counts.shape[0]
    if C == 1:
        return [0]
    i, j = np.unravel_index(np.argmax(counts), counts.shape)
    order = [int(i), int(j)]
    rest = set(range(C)) - set(order)
    while rest:
        best, best_c, at_end = None, -1, True
        for r in rest:
            if counts[order[-1], r] > best_c:
                best, best_c, at_end = r, counts[order[-1], r], True
            if counts[order[0], r] > best_c:
                best, best_c, at_end = r, counts[order[0], r], False
        if at_end:
            order.append(int(best))
        else:
            order.insert(0, int(best))
        rest.discard(best)
    return order


def _chain_tracks(order, matches, N):
    """Chain adjacent-pair matches into multi-camera tracks. Returns obs
    [M, C] slot per camera (-1 = none), one row per track of >= 2 views."""
    C = len(order)

    def get(ci, cj, a):
        """The match of slot a from order position ci to cj (adjacent)."""
        i, j = order[ci], order[cj]
        if i < j:
            return matches[(i, j)][a]
        hits = np.nonzero(matches[(j, i)] == a)[0]
        return hits[0] if len(hits) else -1

    used = [np.zeros(N, bool) for _ in range(C)]
    rows = []
    for start in range(C - 1):
        for a in range(N):
            if used[start][a]:
                continue
            row = -np.ones(C, int)
            row[start] = a
            cur = a
            for nxt in range(start + 1, C):
                b = get(nxt - 1, nxt, cur)
                if b < 0:
                    break
                row[nxt] = b
                cur = b
            if (row >= 0).sum() >= 2:
                for ci in range(C):
                    if row[ci] >= 0:
                        used[ci][row[ci]] = True
                obs = -np.ones(C, int)
                for ci in range(C):
                    obs[order[ci]] = row[ci]
                rows.append(obs)
    return np.stack(rows) if rows else np.zeros((0, C), int)


def init_map_multicam(cfg: SlamConfig, K: torch.Tensor, kc: torch.Tensor,
                      pyr, pos: torch.Tensor, valid: torch.Tensor,
                      raw: torch.Tensor | None = None) -> InitMapResult:
    """K [C, 3, 3], kc [C, 5]; pyr: the camera-batched pyramid of the
    frame; pos [C, N, 2] corner positions (undistorted px), valid [C, N].
    Returns the cameras' poses, the reconstructed points, their
    covariances and per-camera feature slots (``ok`` False on failure).

    ``raw`` [C, N, 2], the same corners on the distorted image: the NCC
    blocks are cut there and ``raw`` is what ``kc`` undistorts. Without
    it the init does what the JAX package's does, which cuts the blocks at
    ``pos`` on the distorted image and undistorts ``pos`` a second time
    (``coslam_tpu/slam/initmap.py:176-188``): the same thing where
    ``kc`` is zero, but under the reference's lens distortion a misplaced
    block and a warped geometry (ROADMAP.md, C3)."""
    C, N = valid.shape
    p = cfg.p
    dev = pos.device
    f32 = torch.float32
    fail = InitMapResult(False, None, None, None, None, None, [])
    at = pos if raw is None else raw
    per_cam = [extract_ncc_blocks(pyr.imgs[0][c], at[c], p.ncc_patch_radius)
               for c in range(C)]
    blocks = torch.stack([b for b, _ in per_cam])
    blk_ok = torch.stack([o for _, o in per_cam])
    matches, counts = _pairwise_matches(cfg, K, kc, pos, at, valid,
                                        blocks, blk_ok)
    # no pair matches: a failed init, retried on the next frame (the JAX
    # package's path starts at camera 0 twice here and raises KeyError;
    # ROADMAP.md, C4)
    if counts.max() == 0:
        return fail
    order = _camera_order(counts)
    obs = _chain_tracks(order, matches, N)
    if obs.shape[0] < 30:
        return fail
    pos_np = pos.cpu().numpy()
    xn = [cam.normalize_points(at[c], K[c], kc[c]).cpu().numpy()
          for c in range(C)]
    # seed pair: the best-matched pair
    ci, cj = np.unravel_index(np.argmax(counts), counts.shape)
    ci, cj = int(min(ci, cj)), int(max(ci, cj))
    pair_rows = (obs[:, ci] >= 0) & (obs[:, cj] >= 0)
    if pair_rows.sum() < 16:
        return fail
    x1 = xn[ci][obs[pair_rows, ci]]
    x2 = xn[cj][obs[pair_rows, cj]]
    M0 = x1.shape[0]
    pad = (64 - M0 % 64) % 64
    x1p = torch.as_tensor(np.pad(x1, ((0, pad), (0, 0))), device=dev)
    x2p = torch.as_tensor(np.pad(x2, ((0, pad), (0, 0))), device=dev)
    maskp = torch.zeros((M0 + pad,), dtype=torch.bool, device=dev)
    maskp[:M0] = True
    res = epipolar.ransac_essential(torch.Generator().manual_seed(0), x1p,
                                    x2p, maskp, num_hypotheses=512,
                                    thresh=3e-5)
    R_end, t_end, Xe, good = epipolar.recover_pose_from_essential(
        res.F, x1p, x2p, res.inliers)
    if int(torch.sum(good)) < 12:
        return fail
    # scale anchor: median depth in the seed camera
    med_z = float(nanmedian(torch.where(good, Xe[:, 2],
                                        torch.full_like(Xe[:, 2], np.nan)), 0))
    if not np.isfinite(med_z) or med_z <= 0:
        return fail
    s = p.bootstrap_depth / med_z
    Xe = Xe.cpu().numpy() * s
    Rs = np.zeros((C, 3, 3), np.float32)
    ts = np.zeros((C, 3), np.float32)
    Rs[ci] = np.eye(3)
    Rs[cj] = R_end.cpu().numpy()
    ts[cj] = t_end.cpu().numpy() * s
    # incremental PnP: pose the remaining cameras in order of support,
    # re-triangulating over all posed cameras as they come
    good_np = good.cpu().numpy()[:M0]
    X_seed = Xe[:M0][good_np]
    known_X = {r: X_seed[k] for k, r in
               enumerate(np.nonzero(pair_rows)[0][good_np])}
    posed = {ci, cj}
    fK = float(K[0, 0, 0])
    eye = torch.eye(3, dtype=f32, device=dev)
    while len(posed) < C:
        best_c, best_rows = -1, None
        for c in range(C):
            if c in posed:
                continue
            rows = [r for r in known_X if obs[r, c] >= 0]
            if best_rows is None or len(rows) > len(best_rows):
                best_c, best_rows = c, rows
        if best_c < 0 or len(best_rows) < 8:
            return fail
        c = best_c
        Xc = np.stack([known_X[r] for r in best_rows]).astype(np.float32)
        xc = xn[c][obs[best_rows, c]].astype(np.float32)
        # IRLS-LM from the best-connected posed camera's pose: DLT PnP
        # degenerates on near-coplanar init points, and rig cameras sit
        # close together
        near = max(posed, key=lambda cc: sum(obs[r, cc] >= 0
                                             for r in best_rows))
        out = irls_pose(eye, torch.as_tensor(Rs[near], device=dev),
                        torch.as_tensor(ts[near], device=dev),
                        torch.as_tensor(Xc, device=dev),
                        torch.as_tensor(xc, device=dev),
                        torch.ones(Xc.shape[0], dtype=torch.bool, device=dev),
                        tau=30.0 / fK, n_irls=6, n_lm=12)
        n_inl = int(torch.sum(out.err < 4.0 / fK))
        if n_inl < 8 or not bool(torch.all(torch.isfinite(out.R))):
            return fail
        Rs[c] = out.R.cpu().numpy()
        ts[c] = out.t.cpu().numpy()
        posed.add(c)
        # extend the known points with rows seen by >= 2 posed cameras
        posed_list = sorted(posed)
        new_rows, av, bv = [], [], []
        for rr in range(obs.shape[0]):
            if rr in known_X:
                continue
            vis = [cc for cc in posed_list if obs[rr, cc] >= 0]
            if len(vis) >= 2:
                new_rows.append(rr)
                av.append(vis[0])
                bv.append(vis[-1])
        if new_rows:
            av, bv, ra = np.array(av), np.array(bv), np.array(new_rows)
            xa = np.stack([xn[a][obs[r, a]] for r, a in zip(ra, av)])
            xb = np.stack([xn[b][obs[r, b]] for r, b in zip(ra, bv)])

            def T(a):
                return torch.as_tensor(a, device=dev)
            Xr, s1, s2, _ = triangulate_two_view_midpoint(
                T(Rs[av]), T(ts[av]), T(Rs[bv]), T(ts[bv]), T(xa), T(xb))
            Xr = Xr.cpu().numpy()
            okr = ((s1 > 0) & (s2 > 0)).cpu().numpy()
            for k, rr in enumerate(ra):
                if okr[k]:
                    known_X[rr] = Xr[k]
    # reconstruct every track (>= 2 views) with the final poses
    M = obs.shape[0]
    mask = obs >= 0
    xns = np.zeros((M, C, 2), np.float32)
    px_all = np.zeros((M, C, 2), np.float32)
    for c in range(C):
        rowsc = mask[:, c]
        xns[rowsc, c] = xn[c][obs[rowsc, c]]
        px_all[rowsc, c] = pos_np[c][obs[rowsc, c]]
    Rs_t = torch.as_tensor(Rs, device=dev)
    ts_t = torch.as_tensor(ts, device=dev)
    mask_t = torch.as_tensor(mask, device=dev)
    X = triangulate_multiview(Rs_t.expand(M, C, 3, 3), ts_t.expand(M, C, 3),
                              torch.as_tensor(xns, device=dev), mask_t)
    # init bundle adjustment (RobustBundleRTS right after initMap): the
    # 8-point E estimate degrades on near-planar scenes; a robust BA over
    # all cameras and points restores consistency before the commit. The
    # point axis is padded to a multiple of 256 as in the JAX package.
    Mp = int(np.ceil(max(M, 1) / 256) * 256)
    obs_px = torch.zeros((Mp, C, 2), dtype=f32, device=dev)
    obs_px[:M] = torch.as_tensor(px_all, device=dev)
    obs_ok = torch.zeros((Mp, C), dtype=torch.bool, device=dev)
    obs_ok[:M] = mask_t
    X0 = torch.zeros((Mp, 3), dtype=f32, device=dev)
    X0[:M] = X
    cam_fixed = torch.zeros((C,), dtype=torch.bool, device=dev)
    cam_fixed[ci] = True
    prob = BAProblem(
        K=K, R=Rs_t, t=ts_t, X=X0,
        obs_cam=torch.arange(C, device=dev).repeat(Mp),
        obs_pt=torch.arange(Mp, device=dev).repeat_interleave(C),
        obs_px=obs_px.reshape(Mp * C, 2), obs_valid=obs_ok.reshape(-1),
        cam_fixed=cam_fixed,
        point_fixed=torch.zeros((Mp,), dtype=torch.bool, device=dev))
    bres = bundle_adjust(prob, max_err=p.max_err, max_iter=3, inner_iter=25)
    if bool(torch.all(torch.isfinite(bres.R))) and \
            bool(torch.all(torch.isfinite(bres.X[:M]))):
        Rs_t, ts_t, X = bres.R, bres.t, bres.X[:M]
        Rs, ts = Rs_t.cpu().numpy(), ts_t.cpu().numpy()
    # reprojection gate (undistorted px) and positive depth in every view
    pr = cam.project_points(K[None], Rs_t[None], ts_t[None], X[:, None])
    err = np.linalg.norm(pr.cpu().numpy() - px_all, axis=-1)
    depth = cam.camera_depths(Rs_t[None], ts_t[None], X[:, None]).cpu().numpy()
    X = X.cpu().numpy()
    ok_view = (~mask) | ((err < 2.0 * p.reproj_new_point_gate)
                         & (depth > 1e-3))
    keep = ok_view.all(axis=1) & (mask.sum(1) >= 2) & \
        np.isfinite(X).all(axis=1)
    if keep.sum() < 30:
        return fail
    Xk = X[keep]
    Mk = Xk.shape[0]
    covX = triangulation_cov(
        K.expand(Mk, C, 3, 3), Rs_t.expand(Mk, C, 3, 3),
        ts_t.expand(Mk, C, 3), torch.as_tensor(Xk, device=dev),
        torch.as_tensor(mask[keep], device=dev), pixel_var=p.pixel_err_var)
    return InitMapResult(True, Rs, ts, Xk.astype(np.float32),
                         covX.cpu().numpy(), obs[keep], order)
