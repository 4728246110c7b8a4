"""Epipolar geometry: F/E estimation, batched-hypothesis RANSAC, E
decomposition (the port of ``coslam_tpu/geometry/epipolar.py``).

RANSAC draws its minimal samples from a ``torch.Generator`` (on the CPU,
so a seed gives the same samples on every device) instead of
``jax.random``: the two streams differ, so runs are compared by consensus
set and pose, not bit for bit.

Conventions: x2^T E x1 = 0 with E = [t21]_x R21 and x2 = R21 x1 + t21.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from coslam_torch.geometry.triangulate import triangulate_two_view


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _normalize_for_8pt(x: torch.Tensor, w: torch.Tensor):
    """Hartley normalization with weights w [..., N]. Returns (xs, T)."""
    wsum = torch.sum(w, dim=-1, keepdim=True) + 1e-9
    mean = torch.sum(x * w[..., None], dim=-2, keepdim=True) \
        / wsum[..., None]
    d = torch.linalg.norm(x - mean, dim=-1)
    mean_d = torch.sum(d * w, dim=-1, keepdim=True) / wsum
    s = math.sqrt(2.0) / torch.clamp(mean_d, min=1e-9)
    xs = (x - mean) * s[..., None]
    s0 = s[..., 0]
    zeros = torch.zeros_like(s0)
    ones = torch.ones_like(s0)
    mx, my = mean[..., 0, 0], mean[..., 0, 1]
    T = torch.stack([
        torch.stack([s0, zeros, -s0 * mx], dim=-1),
        torch.stack([zeros, s0, -s0 * my], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)
    return xs, T


def fit_fundamental(x1: torch.Tensor, x2: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Weighted normalized 8-point fit. x1, x2: [..., N, 2]; w: [..., N].
    Returns F (E on normalized coords), rank 2, unit Frobenius norm."""
    x1s, T1 = _normalize_for_8pt(x1, w)
    x2s, T2 = _normalize_for_8pt(x2, w)
    u1, v1 = x1s[..., 0], x1s[..., 1]
    u2, v2 = x2s[..., 0], x2s[..., 1]
    ones = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     ones], dim=-1)
    A = A * w[..., None]
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    _, V = torch.linalg.eigh(AtA)
    f = V[..., :, 0]
    F = f.reshape(*f.shape[:-1], 3, 3)
    U, s, Vt = torch.linalg.svd(F)
    s2 = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    F = (U * s2[..., None, :]) @ Vt
    F = T2.transpose(-1, -2) @ F @ T1
    nrm = torch.linalg.norm(F, dim=(-2, -1), keepdim=True)
    return F / torch.clamp(nrm, min=1e-12)


def sampson_error(F: torch.Tensor, x1: torch.Tensor,
                  x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) error. F: [..., 3, 3]; x*: [..., N, 2]."""
    x1h = _homog(x1)
    x2h = _homog(x2)
    Fx1 = torch.einsum("...ij,...nj->...ni", F, x1h)
    Ftx2 = torch.einsum("...ji,...nj->...ni", F, x2h)
    num = torch.square(torch.sum(x2h * Fx1, dim=-1))
    den = (torch.square(Fx1[..., 0]) + torch.square(Fx1[..., 1])
           + torch.square(Ftx2[..., 0]) + torch.square(Ftx2[..., 1]))
    return num / torch.clamp(den, min=1e-12)


def sample_indices(gen: torch.Generator, mask: torch.Tensor,
                   num_hypotheses: int, sample_size: int) -> torch.Tensor:
    """[num_hypotheses, sample_size] indices drawn uniformly, with
    replacement, from the rows where ``mask`` holds (all 0 if none)."""
    valid_idx = torch.nonzero(mask.cpu())[:, 0]
    pick = torch.randint(0, max(len(valid_idx), 1),
                         (num_hypotheses, sample_size), generator=gen)
    return valid_idx[pick] if len(valid_idx) else pick.zero_()


def sample_seed(gen: torch.Generator) -> int:
    """A seed for the 5-point solver's numpy sampler."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen))


class RansacResult(NamedTuple):
    F: torch.Tensor           # [3, 3] best model (refit on inliers)
    inliers: torch.Tensor     # [N] bool
    num_inliers: torch.Tensor


def ransac_fundamental(gen: torch.Generator, x1: torch.Tensor,
                       x2: torch.Tensor, mask: torch.Tensor,
                       num_hypotheses: int = 256, thresh: float = 2e-5,
                       sample_size: int = 8,
                       refit_rounds: int = 2) -> RansacResult:
    """Batched-hypothesis RANSAC for F (or E on normalized coords).

    gen: a CPU ``torch.Generator`` for the minimal samples (uniform with
    replacement over the valid correspondences, as the JAX package's
    categorical draw). x1, x2: [N, 2]; mask: [N]. thresh is on Sampson
    error."""
    idx = sample_indices(gen, mask, num_hypotheses, sample_size).to(
        x1.device)
    s_x1 = x1[idx]            # [S, 8, 2]
    s_x2 = x2[idx]
    w = torch.ones(idx.shape, dtype=x1.dtype, device=x1.device)
    Fs = fit_fundamental(s_x1, s_x2, w)                    # [S, 3, 3]
    errs = sampson_error(Fs, x1[None], x2[None])           # [S, N]
    inl = (errs < thresh) & mask[None, :]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts)
    inliers = inl[best]
    F = Fs[best]
    for _ in range(refit_rounds):
        F = fit_fundamental(x1, x2, inliers.to(x1.dtype))
        inliers = (sampson_error(F, x1, x2) < thresh) & mask
    return RansacResult(F=F, inliers=inliers, num_inliers=torch.sum(inliers))


def ransac_essential(gen: torch.Generator, x1n: torch.Tensor,
                     x2n: torch.Tensor, mask: torch.Tensor,
                     num_hypotheses: int = 256, thresh: float = 2e-5,
                     n_hyp_5pt: int = 64) -> RansacResult:
    """Essential-matrix RANSAC on normalized coordinates: the batched
    8-point path plus the 5-point minimal solver, keeping whichever model
    explains more correspondences."""
    res8 = ransac_fundamental(gen, x1n, x2n, mask,
                              num_hypotheses=num_hypotheses, thresh=thresh)
    if n_hyp_5pt <= 0 or int(torch.sum(mask)) < 5:
        return res8
    from coslam_torch.geometry.fivepoint import ransac_essential_5pt
    seed = sample_seed(gen)
    E5, inl5, n5 = ransac_essential_5pt(
        x1n.cpu().numpy(), x2n.cpu().numpy(), mask.cpu().numpy(),
        n_hyp=n_hyp_5pt, thresh=thresh, seed=seed)
    if n5 <= int(res8.num_inliers):
        return res8
    # polish the 5-point winner with a weighted all-inlier refit
    E5t = torch.as_tensor(np.asarray(E5), dtype=x1n.dtype, device=x1n.device)
    inl5t = torch.as_tensor(inl5, device=x1n.device)
    inliers = inl5t
    F = E5t
    for _ in range(2):
        F = fit_fundamental(x1n, x2n, inliers.to(x1n.dtype))
        inliers = (sampson_error(F, x1n, x2n) < thresh) & mask
    if int(torch.sum(inliers)) < n5:   # keep the refit only if no loss
        F, inliers = E5t, inl5t
    return RansacResult(F=F, inliers=inliers,
                        num_inliers=torch.sum(inliers))


def decompose_essential(E: torch.Tensor):
    """E -> four (R, t) candidates, ||t|| = 1. Returns (Rs [4,3,3], ts [4,3])."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([t, -t, t, -t], dim=-2)
    return Rs, ts


def recover_pose_from_essential(E: torch.Tensor, x1n: torch.Tensor,
                                x2n: torch.Tensor, mask: torch.Tensor):
    """Pick the (R21, t21) candidate with maximal cheirality support and
    triangulate. Returns (R, t, X [N, 3], good [N] bool)."""
    Rs, ts = decompose_essential(E)  # [4,3,3], [4,3]
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    zero = torch.zeros((3,), dtype=E.dtype, device=E.device)
    Xs, oks = [], []
    for k in range(4):
        X = triangulate_two_view(eye, zero, Rs[k], ts[k], x1n, x2n)
        z1 = X[..., 2]
        z2 = (X @ Rs[k].T)[..., 2] + ts[k, 2]
        Xs.append(X)
        oks.append((z1 > 1e-6) & (z2 > 1e-6) & mask)
    Xs, oks = torch.stack(Xs), torch.stack(oks)
    best = torch.argmax(torch.sum(oks, dim=-1))
    return Rs[best], ts[best], Xs[best], oks[best]


def essential_from_poses(R1, t1, R2, t2) -> torch.Tensor:
    """E = [t21]_x R21 for cameras (R1,t1), (R2,t2) in a common frame."""
    from coslam_torch.geometry.se3 import relative_pose, so3_hat
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
