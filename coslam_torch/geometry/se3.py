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


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 3] axis-angle (theta in [0, pi])."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1) * 0.5
    sin_t = torch.sin(theta)
    small = theta < 1e-4
    scale = torch.where(small, 1.0 + theta * theta / 6.0,
                        theta / torch.where(small, torch.ones_like(sin_t),
                                            sin_t + _EPS))
    w = v * scale[..., None]
    # near theta = pi the vee formula degenerates; use diagonal extraction
    near_pi = theta > 3.1
    Rd = torch.diagonal(R, dim1=-2, dim2=-1)
    ct = cos_t[..., None]
    axis_sq = torch.clamp(
        (Rd - ct) / torch.where(ct < 1.0, 1.0 - ct, torch.ones_like(ct)),
        0.0, 1.0)
    axis = torch.sqrt(axis_sq)
    sx = torch.sign(R[..., 2, 1] - R[..., 1, 2])
    sy = torch.sign(R[..., 0, 2] - R[..., 2, 0])
    sz = torch.sign(R[..., 1, 0] - R[..., 0, 1])
    one = torch.ones_like(sx)
    s = torch.stack([torch.where(sx == 0, one, sx),
                     torch.where(sy == 0, one, sy),
                     torch.where(sz == 0, one, sz)], dim=-1)
    w_pi = axis * s * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w)


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


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> [..., 6] twist (w, v)."""
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    W = so3_hat(w)
    W2 = W @ W
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - theta * torch.sin(theta)
         / (2.0 * (1.0 - torch.cos(theta)) + _EPS)) / (theta2 + _EPS))
    Vinv = _eye_like(R, W.shape) - 0.5 * W + cot_term[..., None, None] * W2
    v = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([w, v], dim=-1)


def project_to_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation to [..., 3, 3] M (Frobenius), det +1."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    return (U * D[..., None, :]) @ Vt


def orthonormalize_fast(R: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Newton re-orthonormalization: R <- R (3I - R^T R) / 2."""
    eye3 = 3.0 * torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        R = 0.5 * R @ (eye3 - R.transpose(-1, -2) @ R)
    return R


def compose(Ra, ta, Rb, tb):
    """(Ra,ta) after (Rb,tb): x -> Ra(Rb x + tb) + ta."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def invert(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


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
