"""Camera grouping: view-overlap costs and connected components (the port
of ``coslam_tpu/slam/grouping.py``).

The overlap between two cameras is the number of alive map points both
observe, weighted by the image coverage of those shared points' convex
hull (getViewOverlapCosts); all C^2 hulls are one batched device
reduction (``geometry/hull.py``). The group ids themselves are tiny host
data.
"""

from __future__ import annotations

import numpy as np
import torch

from coslam_torch.config import SlamConfig
from coslam_torch.geometry.hull import hull_area_masked
from coslam_torch.slam.classify import point_obs_table
from coslam_torch.slam.merge import scan_candidates_device
from coslam_torch.slam.state import ST_ALIVE, SlamState


def view_overlap_counts(state: SlamState):
    """[C, C] shared alive-map-point counts and [C, C] hull areas (px^2)
    of the shared points in camera i's image."""
    tracks, mappts = state.tracks, state.mappts
    P = mappts.xyz.shape[0]
    _, obs_px, obs_ok = point_obs_table(tracks, P)
    ok = obs_ok & (mappts.status == ST_ALIVE)[:, None]        # [P, C]
    okf = ok.to(torch.float32)
    shared = okf.T @ okf
    pair_ok = ok[:, :, None] & ok[:, None, :]                 # [P, C, C]
    x = obs_px[..., 0][:, :, None].expand(pair_ok.shape)
    y = obs_px[..., 1][:, :, None].expand(pair_ok.shape)
    return shared, hull_area_masked(x, y, pair_ok)


def host_scan_device(state: SlamState, K: torch.Tensor, h: int, w: int,
                     dormant_age: int) -> torch.Tensor:
    """Every periodic host-decision reduction in one packed [C, 3C+2]
    tensor (one device-to-host copy): shared counts, hull areas,
    merge-candidate counts, per-owner alive counts, dormant counts."""
    shared, area = view_overlap_counts(state)
    mc, alive_own, dorm = scan_candidates_device(state, K, h, w, dormant_age)
    return torch.cat([shared, area, mc, alive_own[:, None],
                      dorm[:, None].to(torch.float32)], dim=1)


def camera_grouping(state: SlamState, cfg: SlamConfig, min_shared: int = 20,
                    min_cover: float = 0.2, shared: np.ndarray | None = None,
                    area: np.ndarray | None = None) -> np.ndarray:
    """[C] group ids: connected components of the graph whose edges join
    cameras sharing >= ``min_shared`` points whose hull covers >=
    ``min_cover`` of both images."""
    C = cfg.num_cameras
    if shared is None or area is None:
        shared, area = (a.cpu().numpy() for a in view_overlap_counts(state))
    img_area = float(cfg.image_height * cfg.image_width)
    parent = list(range(C))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i in range(C):
        for j in range(i + 1, C):
            cover = min(area[i, j], area[j, i]) / img_area
            if shared[i, j] >= min_shared and cover >= min_cover:
                parent[find(i)] = find(j)
    roots = {}
    gid = np.zeros(C, np.int32)
    for c in range(C):
        gid[c] = roots.setdefault(find(c), len(roots))
    return gid


def group_camera_tuples(group_id: np.ndarray) -> list[tuple[int, ...]]:
    """Ordered camera tuples of the groups with >= 2 cameras (the unit of
    multi-view inter-camera mapping)."""
    out = []
    for g in np.unique(group_id):
        cams = tuple(int(c) for c in np.nonzero(group_id == g)[0])
        if len(cams) >= 2:
            out.append(cams)
    return out

