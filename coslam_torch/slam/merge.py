"""Periodic duplicate unification of close map points and the device
candidate scan behind the grouping, merge and loop checks (the port of
``coslam_tpu/slam/merge.py::fuse_close_points`` and
``scan_candidates_device``; group merging itself is not ported yet)."""

from __future__ import annotations

import torch

from coslam_torch.config import SlamConfig
from coslam_torch.slam.state import PT_STATIC, ST_ALIVE, ST_FALSE, SlamState


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
    n = int(torch.sum(kill))
    if n == 0:
        return state, 0
    status = torch.where(kill, torch.full_like(mp.status, ST_FALSE),
                         mp.status)
    return state._replace(mappts=mp._replace(status=status)), n
