"""PnP: absolute pose from 3D-2D correspondences (the port of
``coslam_tpu/geometry/pnp.py``): a Hartley-normalized weighted DLT and a
batched-hypothesis RANSAC around it. Callers polish the RANSAC pose with
the IRLS solver (``solvers/pose.py``).

RANSAC draws its minimal samples from a CPU ``torch.Generator`` instead of
``jax.random``: the same distribution per tier, another stream, so runs
are compared by consensus and pose, not sample for sample.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from coslam_torch.geometry.se3 import project_to_so3


def pnp_dlt(X: torch.Tensor, xn: torch.Tensor, w: torch.Tensor):
    """Weighted DLT pose. X: [..., N, 3] world, xn: [..., N, 2] normalized,
    w: [..., N]. Returns (R [..., 3, 3], t [..., 3]).

    Solves x ~ [R|t] X up to scale on Hartley-normalized world points
    (centroid to the origin, RMS radius sqrt(3)): squaring raw scene
    coordinates into AtA leaves a float32 12x12 eigh without a usable null
    vector. Scale and sign come from det(M) > 0 and |det M| = 1, then M is
    projected onto SO(3)."""
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    c = torch.sum(X * wn[..., None], dim=-2, keepdim=True)     # [..., 1, 3]
    Xc_ = X - c
    rms = torch.sqrt(torch.clamp(torch.sum(
        torch.sum(Xc_ * Xc_, dim=-1) * wn, dim=-1), min=1e-12))
    s = math.sqrt(3.0) / rms
    Xh_ = Xc_ * s[..., None, None]
    Xh = torch.cat([Xh_, torch.ones_like(Xh_[..., :1])], dim=-1)
    zeros = torch.zeros_like(Xh)
    u = xn[..., 0:1]
    v = xn[..., 1:2]
    row1 = torch.cat([Xh, zeros, -u * Xh], dim=-1)             # [..., N, 12]
    row2 = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    A = torch.cat([row1 * w[..., None], row2 * w[..., None]], dim=-2)
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    _, V = torch.linalg.eigh(AtA)
    P = V[..., :, 0].reshape(*V.shape[:-2], 3, 4)
    # un-normalize: x ~ P_hat [s (X - c); 1]  =>  M = s M_hat,
    # t = t_hat - M c
    M = P[..., :, :3] * s[..., None, None]
    t = P[..., :, 3] - torch.einsum("...ij,...j->...i", M, c[..., 0, :])
    det = torch.linalg.det(M)
    sign = torch.where(det >= 0, 1.0, -1.0)
    scale = (torch.abs(det) + 1e-20) ** (1.0 / 3.0)
    M = M * (sign / scale)[..., None, None]
    t = t * (sign / scale)[..., None]
    return project_to_so3(M), t


class PnPRansacResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor


def _draw(gen: torch.Generator, allowed: torch.Tensor, n: int,
          sample_size: int) -> torch.Tensor:
    """[n, sample_size] indices drawn uniformly with replacement from the
    True entries of ``allowed`` (index 0 when none is)."""
    pool = torch.nonzero(allowed.cpu())[:, 0]
    pick = torch.randint(0, max(len(pool), 1), (n, sample_size),
                         generator=gen)
    return pool[pick] if len(pool) else torch.zeros_like(pick)


def ransac_pnp(gen: torch.Generator, X: torch.Tensor, xn: torch.Tensor,
               mask: torch.Tensor, num_hypotheses: int = 256,
               thresh: float = 0.01, sample_size: int = 6,
               refit_rounds: int = 2, score: torch.Tensor | None = None,
               R0: torch.Tensor | None = None,
               t0: torch.Tensor | None = None) -> PnPRansacResult:
    """Batched-hypothesis PnP RANSAC; ``thresh`` is on the normalized
    reprojection distance (~ px / focal).

    With ``score`` ([N] match quality, e.g. NCC) the sampling is
    PROSAC-tiered: half the hypotheses draw from the top 48 matches by
    score, a quarter from the top 128, the rest from all, every draw with
    replacement. Scoring and the refits use all points. ``R0``/``t0`` add
    one caller-supplied hypothesis. A refit that loses consensus does not
    replace its hypothesis."""
    dev = X.device
    S = num_hypotheses
    if score is not None:
        s = torch.where(mask, score, torch.full_like(score, -math.inf))
        order = torch.argsort(-s, stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(len(order), device=dev)
        n_ok = int(torch.sum(mask))
        k1 = min(max(n_ok, sample_size), 48)
        k2 = min(max(n_ok, sample_size), 128)
        idx = torch.cat([
            _draw(gen, mask & (rank < k1), S // 2, sample_size),
            _draw(gen, mask & (rank < k2), S // 4, sample_size),
            _draw(gen, mask, S - S // 2 - S // 4, sample_size)])
    else:
        idx = _draw(gen, mask, S, sample_size)
    idx = idx.to(dev)
    Rs, ts = pnp_dlt(X[idx], xn[idx], torch.ones(idx.shape, dtype=X.dtype,
                                                 device=dev))
    if R0 is not None:
        Rs = torch.cat([Rs, R0[None].to(Rs.dtype)])
        ts = torch.cat([ts, t0[None].to(ts.dtype)])

    def residual(R, t):
        Xc = torch.einsum("...ij,nj->...ni", R, X) + t[..., None, :]
        z = Xc[..., 2]
        zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        pr = Xc[..., :2] / zs[..., None]
        return torch.linalg.norm(pr - xn, dim=-1), z > 1e-6

    errs, depth_ok = residual(Rs, ts)                      # [S, N]
    inl = (errs < thresh) & depth_ok & mask[None, :]
    best = torch.argmax(torch.sum(inl, dim=-1))
    R, t, inliers = Rs[best], ts[best], inl[best]
    for _ in range(refit_rounds):
        R2, t2 = pnp_dlt(X, xn, inliers.to(X.dtype))
        e, dok = residual(R2, t2)
        new_inl = (e < thresh) & dok & mask
        better = torch.sum(new_inl) >= torch.sum(inliers)
        R = torch.where(better, R2, R)
        t = torch.where(better, t2, t)
        inliers = torch.where(better, new_inl, inliers)
    return PnPRansacResult(R=R, t=t, inliers=inliers,
                           num_inliers=torch.sum(inliers))
