"""Structure-tensor corner detection: cornerness, NMS, masked top-k (the
port of ``coslam_tpu/ops/corners.py``).

cornerness = Shi-Tomasi min eigenvalue of the box-filtered structure
tensor; NMS = equality with a (2r+1)^2 max-pool; live-track suppression =
an occupancy image dilated by the same pool; compaction = top-k over
block maxima. The top-k is a stable descending sort, so ties keep the
lower index first as ``jax.lax.top_k`` does (``torch.topk`` promises no
order on ties).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from slambench.reference.frozen.config import KLTConfig
from slambench.reference.frozen.ops.image import box_filter, max_pool_same


def cornerness_map(dx: torch.Tensor, dy: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """Min-eigenvalue cornerness. dx, dy: [C, H, W] image derivatives."""
    gxx = box_filter(dx * dx, radius)
    gyy = box_filter(dy * dy, radius)
    gxy = box_filter(dx * dy, radius)
    half_tr = 0.5 * (gxx + gyy)
    half_df = 0.5 * (gxx - gyy)
    return half_tr - torch.sqrt(half_df * half_df + gxy * gxy + 1e-12)


class CornerResult(NamedTuple):
    pos: torch.Tensor     # [C, K, 2] (x, y)
    score: torch.Tensor   # [C, K]
    valid: torch.Tensor   # [C, K]


def _occupancy(shape_hw, pos: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Rasterize feature positions into [C, H, W] 0/1 images."""
    h, w = shape_hw
    C = pos.shape[0]
    xi = torch.clamp(torch.round(pos[..., 0]).long(), 0, w - 1)
    yi = torch.clamp(torch.round(pos[..., 1]).long(), 0, h - 1)
    flat = torch.zeros((C, h * w), dtype=torch.float32, device=pos.device)
    flat = flat.scatter_reduce(1, yi * w + xi, valid.to(torch.float32),
                               reduce="amax", include_self=True)
    return flat.reshape(C, h, w)


def _topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties broken toward the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _block_reduce_max(x: torch.Tensor, B: int, pad_value: float):
    """Max over non-overlapping BxB blocks, hi-side padded with pad_value."""
    _, h, w = x.shape
    xp = F.pad(x, (0, -w % B, 0, -h % B), value=pad_value)
    return F.max_pool2d(xp[None], kernel_size=B, stride=B)[0]


def detect_corners(img: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                   cfg: KLTConfig, k: int,
                   exclude_pos: torch.Tensor | None = None,
                   exclude_valid: torch.Tensor | None = None) -> CornerResult:
    """Detect up to k corners per camera. img/dx/dy: [C, H, W] (level-0
    pyramid entries); ``exclude_pos`` [C, M, 2] suppresses detections
    within ``cfg.min_distance`` of live tracks."""
    c, h, w = img.shape
    dev = img.device
    corner = cornerness_map(dx, dy, cfg.window_radius)
    bx = torch.arange(w, device=dev)[None, :].expand(h, w)
    by = torch.arange(h, device=dev)[:, None].expand(h, w)
    b = cfg.border
    border_ok = (bx >= b) & (bx < w - b) & (by >= b) & (by < h - b)
    zero = torch.zeros_like(corner)
    corner = torch.where(border_ok[None], corner, zero)
    pooled = max_pool_same(corner, cfg.min_distance)
    is_max = (corner >= pooled) & (corner > cfg.min_cornerness)
    if exclude_pos is not None:
        occ = _occupancy((h, w), exclude_pos, exclude_valid)
        is_max = is_max & ~(max_pool_same(occ, cfg.min_distance) > 0.5)
    masked = torch.where(is_max, corner, zero)
    # NMS keeps survivors > min_distance apart, so a BxB block with
    # B <= min_distance + 1 holds at most one survivor: sort block maxima
    B = cfg.min_distance + 1
    nb = -(-h // B) * -(-w // B)
    if nb >= k:
        blockmax = _block_reduce_max(masked, B, 0.0)
        up = blockmax.repeat_interleave(B, dim=1).repeat_interleave(B, dim=2)
        up = up[:, :h, :w]
        flat_idx = (by * w + bx).to(torch.float32)   # < 2^24, f32-exact
        cand = torch.where((masked == up) & (masked > 0.0), flat_idx,
                           torch.full_like(masked, -1.0))
        blockidx = _block_reduce_max(cand, B, -1.0)
        score, bsel = _topk_stable(blockmax.reshape(c, -1), k)
        idx = torch.gather(blockidx.reshape(c, -1), 1, bsel).long()
        idx = torch.clamp(idx, min=0)
    else:
        score, idx = _topk_stable(masked.reshape(c, h * w), k)
    pos = torch.stack([(idx % w).to(img.dtype), (idx // w).to(img.dtype)],
                      dim=-1)
    return CornerResult(pos=pos, score=score, valid=score > 0.0)
