"""2D convex hulls (the port of ``coslam_tpu/geometry/hull.py``): an exact
host-side hull with its polygon area and point-in-hull test (the merge
and loop-closure overlap masks), and a device-side hull area of batched
masked point sets (the grouping's view-overlap costs).

Device side: as the direction theta sweeps the circle, the set's extreme
point in direction theta visits the hull's vertices in order, so K
direction probes give up to K hull vertices already in polygon order and
the shoelace formula gives an inner approximation of the hull area (exact
when the hull has at most K vertices the probes catch). Masked max, argmax
and gather only: no sort, no data-dependent shapes.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Exact convex hull by Andrew's monotone chain. points: [N, 2].
    Returns the hull's vertices [H, 2] counter-clockwise (no repeated
    endpoint); degenerate inputs (N < 3, collinear) return the extreme
    points found."""
    pts = np.unique(np.asarray(points, np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def chain(seq):
        out: list[np.ndarray] = []
        for p in seq:
            while len(out) >= 2 and cross(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out

    return np.asarray(chain(pts)[:-1] + chain(pts[::-1])[:-1])


def polygon_area(verts: np.ndarray) -> float:
    """Shoelace area of a simple polygon [H, 2] (positive either way)."""
    v = np.asarray(verts, np.float64)
    if len(v) < 3:
        return 0.0
    x, y = v[:, 0], v[:, 1]
    return float(0.5 * abs(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)))


def points_in_hull(pts: np.ndarray, hull: np.ndarray,
                   eps: float = 1e-9) -> np.ndarray:
    """[N] bool: inside-or-on a CCW hull [H, 2], by half-plane tests
    (checkViewOverlap's hull mask)."""
    pts = np.asarray(pts, np.float64)
    hull = np.asarray(hull, np.float64)
    if len(hull) < 3:
        return np.zeros(len(pts), bool)
    a, b = hull, np.roll(hull, -1, axis=0)
    # cross(b - a, p - a) >= 0 for every edge of a CCW hull
    d = (b[:, 0] - a[:, 0])[None, :] * (pts[:, 1:2] - a[:, 1][None, :]) \
        - (b[:, 1] - a[:, 1])[None, :] * (pts[:, 0:1] - a[:, 0][None, :])
    return np.all(d >= -eps, axis=1)


def hull_area_masked(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                     n_dirs: int = 32) -> torch.Tensor:
    """Convex-hull area of masked point sets, batched over trailing dims.
    x, y: [P, *B] coordinates; mask: [P, *B] bool. Returns [*B] areas
    (0 for empty sets). All ``n_dirs`` probes run as one batch."""
    theta = torch.arange(n_dirs, dtype=x.dtype, device=x.device) \
        * (2.0 * math.pi / n_dirs)
    shape = (n_dirs,) + (1,) * x.dim()
    cth = torch.cos(theta).reshape(shape)
    sth = torch.sin(theta).reshape(shape)
    proj = torch.where(mask[None], cth * x[None] + sth * y[None],
                       torch.full((), -1e30, dtype=x.dtype, device=x.device))
    idx = torch.argmax(proj, dim=1, keepdim=True)            # [K, 1, *B]
    vx = torch.gather(x[None].expand_as(proj), 1, idx)[:, 0]  # [K, *B]
    vy = torch.gather(y[None].expand_as(proj), 1, idx)[:, 0]
    area = 0.5 * torch.abs(torch.sum(
        vx * torch.roll(vy, -1, dims=0) - torch.roll(vx, -1, dims=0) * vy,
        dim=0))
    return torch.where(torch.any(mask, dim=0), area, torch.zeros_like(area))
