"""Camera model: intrinsics, radial-tangential distortion, projection (the
port of ``coslam_tpu/geometry/camera.py``).

OpenCV 5-coefficient distortion (k1, k2, p1, p2, k3); undistortion by a
fixed 8-round fixed-point iteration, as the JAX package does.
"""

from __future__ import annotations

import torch


def distort_normalized(xn: torch.Tensor, kc: torch.Tensor) -> torch.Tensor:
    """Apply radial-tangential distortion to normalized coords [..., 2]."""
    x, y = xn[..., 0], xn[..., 1]
    k1, k2, p1, p2, k3 = (kc[..., i] for i in range(5))
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(xd: torch.Tensor, kc: torch.Tensor,
                         iters: int = 8) -> torch.Tensor:
    """Invert distortion by fixed-point iteration (replaces invDistorParam)."""
    k1, k2, p1, p2, k3 = (kc[..., i] for i in range(5))
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        tx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        ty = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xn = torch.stack([(xd[..., 0] - tx) / radial,
                          (xd[..., 1] - ty) / radial], dim=-1)
    return xn


def pixel_to_normalized(px: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """[..., 2] pixel -> normalized (pre-distortion-removal)."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    s = K[..., 0, 1]
    y = (px[..., 1] - cy) / fy
    x = (px[..., 0] - cx - s * y) / fx
    return torch.stack([x, y], dim=-1)


def normalized_to_pixel(xn: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    s = K[..., 0, 1]
    u = fx * xn[..., 0] + s * xn[..., 1] + cx
    v = fy * xn[..., 1] + cy
    return torch.stack([u, v], dim=-1)


def undistort_points(px: torch.Tensor, K: torch.Tensor,
                     kc: torch.Tensor) -> torch.Tensor:
    """Distorted pixel coords -> undistorted pixel coords."""
    xn = undistort_normalized(pixel_to_normalized(px, K), kc)
    return normalized_to_pixel(xn, K)


def project_points(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                   X: torch.Tensor, kc: torch.Tensor | None = None):
    """World points [..., 3] -> (undistorted) pixels [..., 2]; with ``kc``
    the distortion is applied (for synthesizing raw observations)."""
    Xc = torch.einsum("...ij,...j->...i", R, X) + t
    z = Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.sign(z) * 1e-9 + 1e-12, z)
    xn = Xc[..., :2] / zs[..., None]
    if kc is not None:
        xn = distort_normalized(xn, kc)
    return normalized_to_pixel(xn, K)


def projection_jacobian(K, R, t, X) -> torch.Tensor:
    """d(pixel)/d(X_world): [..., 2, 3] (undistorted pixel space)."""
    Xc = torch.einsum("...ij,...j->...i", R, X) + t
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zi = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    zero = torch.zeros_like(x)
    du = torch.stack(torch.broadcast_tensors(
        fx * zi, zero, -fx * x * zi * zi), dim=-1)
    dv = torch.stack(torch.broadcast_tensors(
        zero, fy * zi, -fy * y * zi * zi), dim=-1)
    J_cam = torch.stack([du, dv], dim=-2)  # [..., 2, 3]
    return J_cam @ R


def mahalanobis2_2d(d: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Squared Mahalanobis distance of 2D residual d under 2x2 cov."""
    a = cov[..., 0, 0]
    b = cov[..., 0, 1]
    c = cov[..., 1, 1]
    det = a * c - b * b
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                      det)
    dx, dy = d[..., 0], d[..., 1]
    return (c * dx * dx - 2.0 * b * dx * dy + a * dy * dy) / det
