"""SO(3) / SE(3) exponential and logarithm maps, batched (the port of
``coslam_tpu/geometry/se3.py``).

Conventions: rotations are 3x3 world->camera matrices; a camera pose is
(R, t) with x_cam = R @ x_world + t. Every function broadcasts over
leading axes.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def _eye_like(x: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(shape)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3], Taylor-safe at 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    W = so3_hat(w)
    W2 = W @ W
    return _eye_like(w, W.shape) + a[..., None, None] * W \
        + b[..., None, None] * W2


def se3_exp(xi: torch.Tensor):
    """[..., 6] twist (w, v) -> (R [..., 3, 3], t [..., 3]); t = V(w) v."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta + _EPS))
    W = so3_hat(w)
    W2 = W @ W
    V = _eye_like(xi, W.shape) + b[..., None, None] * W \
        + c[..., None, None] * W2
    R = so3_exp(w)
    t = torch.einsum("...ij,...j->...i", V, v)
    return R, t


def orthonormalize_fast(R: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Newton re-orthonormalization: R <- R (3I - R^T R) / 2."""
    eye3 = 3.0 * torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        R = 0.5 * R @ (eye3 - R.transpose(-1, -2) @ R)
    return R


def relative_pose(R1, t1, R2, t2):
    """x2 = R21 x1 + t21 with R21 = R2 R1^T, t21 = t2 - R21 t1."""
    R21 = R2 @ R1.transpose(-1, -2)
    t21 = t2 - torch.einsum("...ij,...j->...i", R21, t1)
    return R21, t21


def so3_exp_np(w) -> np.ndarray:
    """Host-side Rodrigues ([3] -> [3, 3], numpy, float64 math)."""
    w = np.asarray(w, np.float64)
    th = float(np.linalg.norm(w))
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-8:
        R = np.eye(3) + W
    else:
        R = np.eye(3) + np.sin(th) / th * W \
            + (1 - np.cos(th)) / th ** 2 * (W @ W)
    return R.astype(np.float32)
