"""Triangulation: multi-view DLT, closed-form 3x3 solves, midpoint
two-view triangulation, covariances and the sequential refinement (the
port of ``coslam_tpu/geometry/triangulate.py``).

The ``*_ln`` variants keep the JAX package's component-list form (3-vectors
and 3x3 blocks as lists of [..., N] tensors): the per-point algebra is the
same and parity with the reference is easiest to read that way.
"""

from __future__ import annotations

import torch

from slambench.reference.frozen.geometry.camera import (projection_jacobian,
                                          project_points, mahalanobis2_2d)


def _floor_abs(x: torch.Tensor, eps: float) -> torch.Tensor:
    """x, with entries of magnitude < eps replaced by eps."""
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def inv3x3_sym(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched symmetric 3x3 inverse (cofactors)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = _floor_abs(a * co00 + b * co01 + c * co02, 1e-12)
    inv = torch.stack([
        torch.stack([co00, co01, co02], dim=-1),
        torch.stack([co01, co11, co12], dim=-1),
        torch.stack([co02, co12, co22], dim=-1),
    ], dim=-2)
    return inv / det[..., None, None]


def triangulate_multiview_ln(Rs, ts, xn, w):
    """Multiview DLT for camera poses shared by every point.

    Rs: [C, 3, 3], ts: [C, 3]; xn: [C, 2, P] normalized coords; w: [C, P]
    weights. Returns (X [3, P], H: the lower-triangular 3x3 nested list of
    [P] normal-matrix entries)."""
    C = Rs.shape[0]
    P = xn.shape[-1]
    kw = dict(dtype=xn.dtype, device=xn.device)
    H = [[torch.full((P,), 1e-9 if i == j else 0.0, **kw) for j in range(3)]
         for i in range(3)]
    g = [torch.zeros((P,), **kw) for _ in range(3)]
    for c in range(C):
        R, t = Rs[c], ts[c]
        x, y = xn[c, 0], xn[c, 1]
        wc = w[c].to(xn.dtype)
        M1 = [x * R[2, j] - R[0, j] for j in range(3)]
        M2 = [y * R[2, j] - R[1, j] for j in range(3)]
        b1 = t[0] - x * t[2]
        b2 = t[1] - y * t[2]
        for i in range(3):
            for j in range(i + 1):
                H[i][j] = H[i][j] + wc * (M1[i] * M1[j] + M2[i] * M2[j])
            g[i] = g[i] + wc * (M1[i] * b1 + M2[i] * b2)
    return torch.stack(solve3x3_sym_ln(H, g)), H


def solve3x3_sym_ln(H, g):
    """Solve the symmetric 3x3 system H x = g with entries as tensors.
    H: 3x3 nested list (lower triangle filled); g: 3 tensors."""
    a00, a01, a02 = H[0][0], H[1][0], H[2][0]
    a11, a12, a22 = H[1][1], H[2][1], H[2][2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = _floor_abs(a00 * c00 + a01 * c01 + a02 * c02, 1e-18)
    x0 = (c00 * g[0] + c01 * g[1] + c02 * g[2]) / det
    x1 = (c01 * g[0] + c11 * g[1] + c12 * g[2]) / det
    x2 = (c02 * g[0] + c12 * g[1] + c22 * g[2]) / det
    return [x0, x1, x2]


def inv3x3_sym_ln(H):
    """Inverse of a symmetric 3x3 with tensor entries (lower triangle
    read): a full symmetric 3x3 nested list."""
    a00, a01, a02 = H[0][0], H[1][0], H[2][0]
    a11, a12, a22 = H[1][1], H[2][1], H[2][2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = _floor_abs(a00 * c00 + a01 * c01 + a02 * c02, 1e-18)
    i00, i01, i02 = c00 / det, c01 / det, c02 / det
    i11, i12, i22 = c11 / det, c12 / det, c22 / det
    return [[i00, i01, i02], [i01, i11, i12], [i02, i12, i22]]


def seq_triangulate_update(K, R, t, px_undist, X, cov,
                           pixel_var: float = 1.0,
                           gate_maha2: float | None = None):
    """One information-filter step folding a new observation into
    (X, cov) (seqTriangulate). Returns (X_new, cov_new, maha2); with
    ``gate_maha2`` updates are suppressed where maha2 > gate_maha2."""
    pred = project_points(K, R, t, X)
    r = px_undist - pred
    J = projection_jacobian(K, R, t, X)                # [..., 2, 3]
    eye2 = torch.eye(2, dtype=X.dtype, device=X.device)
    S = J @ cov @ J.transpose(-1, -2) + pixel_var * eye2
    maha2 = mahalanobis2_2d(r, S)
    a, b, c = S[..., 0, 0], S[..., 0, 1], S[..., 1, 1]
    det = _floor_abs(a * c - b * b, 1e-12)
    Sinv = torch.stack([
        torch.stack([c / det, -b / det], dim=-1),
        torch.stack([-b / det, a / det], dim=-1),
    ], dim=-2)
    Kg = cov @ J.transpose(-1, -2) @ Sinv              # [..., 3, 2]
    X_new = X + torch.einsum("...ij,...j->...i", Kg, r)
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    cov_new = (eye3 - Kg @ J) @ cov
    if gate_maha2 is not None:
        ok = (maha2 <= gate_maha2)[..., None]
        X_new = torch.where(ok, X_new, X)
        cov_new = torch.where(ok[..., None], cov_new, cov)
    return X_new, cov_new, maha2
