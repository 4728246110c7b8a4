"""Map-point observation views (the part of ``coslam_tpu/slam/classify.py``
the monocular path runs: ``point_obs_table``, which keyframe snapshots
need). Dynamic-feature detection and point classification are
multi-camera stages and are not ported yet."""

from __future__ import annotations

import torch

from coslam_torch.util import set_drop


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
