"""Convex-hull areas of batched masked point sets (the device half of
``coslam_tpu/geometry/hull.py``; its exact host-side hull, polygon area
and point-in-hull test serve merge, loop closure and visualization and
come with them).

As the direction theta sweeps the circle, the set's extreme point in
direction theta visits the hull's vertices in order, so K direction
probes give up to K hull vertices already in polygon order and the
shoelace formula gives an inner approximation of the hull area (exact
when the hull has at most K vertices the probes catch). Masked max, argmax
and gather only: no sort, no data-dependent shapes.
"""

from __future__ import annotations

import math

import torch


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
