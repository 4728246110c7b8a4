"""Epipolar geometry: E and F from two poses (the part of the port of
``coslam_tpu/geometry/epipolar.py`` that the tracked step reaches; its
estimation, RANSAC and decomposition are not copied).

Conventions: x2^T E x1 = 0 with E = [t21]_x R21 and x2 = R21 x1 + t21.
"""

from __future__ import annotations

import torch


def essential_from_poses(R1, t1, R2, t2) -> torch.Tensor:
    """E = [t21]_x R21 for cameras (R1,t1), (R2,t2) in a common frame."""
    from slambench.reference.frozen.geometry.se3 import relative_pose, so3_hat
    R21, t21 = relative_pose(R1, t1, R2, t2)
    return so3_hat(t21) @ R21


def fundamental_from_poses(K1, R1, t1, K2, R2, t2) -> torch.Tensor:
    """F = K2^{-T} E K1^{-1}, unit Frobenius norm."""
    E = essential_from_poses(R1, t1, R2, t2)
    # inv_ex: no host sync for the error check
    F = torch.linalg.inv_ex(K2)[0].transpose(-1, -2) @ E @ \
        torch.linalg.inv_ex(K1)[0]
    nrm = torch.linalg.norm(F, dim=(-2, -1), keepdim=True)
    return F / torch.clamp(nrm, min=1e-12)
