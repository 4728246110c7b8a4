"""The per-frame tracked step: pyramid -> KLT + redetect -> pose update ->
pose history -> (several cameras: dynamic-feature voting and map-point
classification) -> new map points -> lifecycle, as one function over the
camera batch (the port of ``coslam_tpu/slam/fused.py``, single-device
path). ``pack_stats`` flattens the per-frame statistics into one vector,
so a tracked frame costs one device-to-host copy.

``frame_steps_scan`` runs a chunk of frames (the reference's
``lax.scan``: here a Python loop, enqueued with no host wait) and
``frame_steps_chunk`` appends the periodic host-decision scan to the
chunk's stats rows, so a chunk costs one copy too.

The JAX step donates its state buffers; here each step returns new
tensors and the engine simply drops the old state. No step waits on the
host: every constant is a Python scalar, a device fill or a tensor kept on
the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from coslam_torch.config import SlamConfig
from coslam_torch.ops.pyramid import build_pyramid
from coslam_torch.slam import steps
from coslam_torch.slam.classify import (classify_map_points,
                                        detect_dynamic_features)
from coslam_torch.slam.grouping import host_scan_device
from coslam_torch.slam.state import PT_DYNAMIC, ST_ALIVE, SlamState


class FrameStats(NamedTuple):
    n_inliers: torch.Tensor   # [C]
    coverage: torch.Tensor    # [C]
    med_depth: torch.Tensor   # [C]
    med_err: torch.Tensor     # [C]
    n_new_points: torch.Tensor
    n_tracked: torch.Tensor   # [C]
    n_static: torch.Tensor    # scalar (0 for mono: classify is multicam)
    n_dynamic: torch.Tensor   # scalar
    n_mapped: torch.Tensor    # [C] tracked features bound to map points
    R: torch.Tensor           # [C, 3, 3] post-step poses
    t: torch.Tensor           # [C, 3]
    dyn_ids: torch.Tensor     # [D] map slots of alive dynamic points (-1)
    dyn_xyz: torch.Tensor     # [D, 3] their positions


def frame_step(state: SlamState, pyr_prev, imgs_cur: torch.Tensor,
               K: torch.Tensor, kc: torch.Tensor, cfg: SlamConfig,
               large_err: bool = False):
    """One tracked frame. Returns (state', pyr_cur, FrameStats); the
    previous frame's pyramid is carried between calls. ``large_err``: the
    settle window after a merge or loop closure, where the realigned poses
    meet widened pose gates (the reference's largeErr frames)."""
    imgs_cur = imgs_cur.to(torch.float32)
    img_hw = (imgs_cur.shape[1], imgs_cur.shape[2])
    pyr_cur = build_pyramid(imgs_cur, cfg.klt.n_levels)
    tracks = steps.advance_tracks(pyr_prev, pyr_cur, state.tracks, K, kc,
                                  state.frame + 1, cfg)
    state = state._replace(tracks=tracks, frame=state.frame + 1)
    out = steps.pose_update(state, K, kc, img_hw, cfg, large_err=large_err)
    state = state._replace(R=out.R, t=out.t, tracks=out.tracks,
                           mappts=out.mappts)
    state = steps.push_pose_history(state)
    if cfg.num_cameras > 1:
        state = detect_dynamic_features(state, K, cfg)
        cls = classify_map_points(state, K, cfg)
        state = state._replace(mappts=cls.mappts, tracks=cls.tracks)
        n_static, n_dynamic = cls.n_static, cls.n_dynamic
    else:
        n_static = torch.zeros((), dtype=torch.int32, device=imgs_cur.device)
        n_dynamic = torch.zeros_like(n_static)
    mappts, tracks2, n_new = steps.new_map_points(state, pyr_cur, K, kc, cfg)
    mappts = steps.lifecycle_update(mappts, state.frame, cfg)
    state = state._replace(mappts=mappts, tracks=tracks2)
    # dynamic snapshot (up to D slots) for the host-side trajectory log
    D = state.kfs.dyn_xyz.shape[1]
    P = mappts.xyz.shape[0]
    dyn = (mappts.status == ST_ALIVE) & (mappts.ptype == PT_DYNAMIC)
    pt_of_d = steps._rank_to_index(dyn)[:D]
    dyn_ids = torch.where(pt_of_d < P, pt_of_d, -1).to(torch.int32)
    dyn_xyz = mappts.xyz[torch.clamp(pt_of_d, 0, P - 1).long()]
    stats = FrameStats(
        n_inliers=out.n_inliers, coverage=out.coverage,
        med_depth=out.med_depth, med_err=out.med_err,
        n_new_points=n_new, n_tracked=torch.sum(tracks2.valid, dim=1),
        n_static=n_static, n_dynamic=n_dynamic,
        n_mapped=torch.sum(tracks2.valid & (tracks2.mpt >= 0), dim=1),
        R=state.R, t=state.t, dyn_ids=dyn_ids, dyn_xyz=dyn_xyz)
    return state, pyr_cur, stats


def pack_stats(fs: FrameStats) -> torch.Tensor:
    """Flatten FrameStats into ONE f32 vector (one device-to-host copy)."""
    f32 = torch.float32
    return torch.cat([
        fs.n_inliers.to(f32), fs.coverage.to(f32),
        fs.med_depth.to(f32), fs.med_err.to(f32),
        fs.n_new_points.reshape(1).to(f32), fs.n_tracked.to(f32),
        fs.n_static.reshape(1).to(f32), fs.n_dynamic.reshape(1).to(f32),
        fs.n_mapped.to(f32), fs.R.reshape(-1).to(f32),
        fs.t.reshape(-1).to(f32), fs.dyn_ids.to(f32),
        fs.dyn_xyz.reshape(-1).to(f32)])


def unpack_stats(v, C: int, D: int) -> FrameStats:
    """Host-side inverse of pack_stats (numpy fields)."""
    v = v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    o = 0

    def take(n, shape=None):
        nonlocal o
        out = v[o:o + n]
        o += n
        return out.reshape(shape) if shape else out

    return FrameStats(
        n_inliers=take(C), coverage=take(C), med_depth=take(C),
        med_err=take(C), n_new_points=take(1)[0], n_tracked=take(C),
        n_static=take(1)[0], n_dynamic=take(1)[0], n_mapped=take(C),
        R=take(9 * C, (C, 3, 3)), t=take(3 * C, (C, 3)),
        dyn_ids=take(D).astype(int), dyn_xyz=take(3 * D, (D, 3)))


def frame_step_packed(state: SlamState, pyr_prev, imgs_cur: torch.Tensor,
                      K: torch.Tensor, kc: torch.Tensor, cfg: SlamConfig,
                      large_err: bool = False):
    """``frame_step`` with its stats packed into one vector (the engine's
    per-frame path). Returns (state', pyr_cur, packed stats)."""
    state, pyr_cur, fs = frame_step(state, pyr_prev, imgs_cur, K, kc, cfg,
                                    large_err=large_err)
    return state, pyr_cur, pack_stats(fs)


def frame_steps_scan(state: SlamState, pyr_prev, imgs_seq: torch.Tensor,
                     K: torch.Tensor, kc: torch.Tensor, cfg: SlamConfig,
                     large_err: bool = False):
    """A chunk of frames, imgs_seq [F, C, H, W], through ``frame_step`` one
    after the other; the host cadence does not run inside the chunk.
    Returns (state', pyr_last, packed stats [F, S]: one ``pack_stats`` row
    per frame)."""
    rows = []
    for imgs in imgs_seq:
        state, pyr_prev, fs = frame_step(state, pyr_prev, imgs, K, kc, cfg,
                                         large_err=large_err)
        rows.append(pack_stats(fs))
    return state, pyr_prev, torch.stack(rows)


def frame_steps_chunk(state: SlamState, pyr_prev, imgs_seq: torch.Tensor,
                      K: torch.Tensor, kc: torch.Tensor, cfg: SlamConfig,
                      large_err: bool = False):
    """``frame_steps_scan`` and the periodic host-decision scan
    (``grouping.host_scan_device`` after the last frame) in ONE flat vector,
    the chunked engine's one device-to-host copy per chunk. Returns
    (state', pyr_last, flat [F * S + C * (3C + 2)]: the stats rows row-major,
    then the scan block)."""
    state, pyr_prev, stats = frame_steps_scan(state, pyr_prev, imgs_seq, K,
                                              kc, cfg, large_err=large_err)
    scan = host_scan_device(state, K, cfg.image_height, cfg.image_width,
                            cfg.p.loop_dormant_age)
    flat = torch.cat([stats.reshape(-1),
                      scan.reshape(-1).to(torch.float32)])
    return state, pyr_prev, flat
