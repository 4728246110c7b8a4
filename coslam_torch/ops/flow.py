"""TV-L1 optical flow, coarse to fine, fixed-point primal-dual (the port of
``coslam_tpu/ops/flow.py``).

Parity component for the reference's GPU flow module (v3d_gpuflow.{h,cpp}
+ OpticalFlow/*.cg shaders, SURVEY.md §2.1), which is vendored with the
CGKLT runtime but not used by the SLAM pipeline (the reference tracks with
KLT only): the classic Zach/Pock/Bischof TV-L1 scheme with warping,
batched over cameras. Plain PyTorch on ``ops/image.py``'s filters and
``ops/patches.py::sample_bilinear``; the JAX op has no Pallas kernel, so
there is none here either. The SLAM hot path never calls it.
"""

from __future__ import annotations

import torch

from coslam_torch.ops.image import downsample2, gaussian_blur
from coslam_torch.ops.patches import sample_bilinear

# sample_bilinear over a leading camera axis: img [C, H, W], pts [C, ..., 2]
_sample = torch.func.vmap(sample_bilinear)


def _warp(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """img, u, v: [C, H, W]. Returns (img sampled at x + u, y + v, in
    bounds)."""
    _, h, w = img.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=img.dtype,
                                         device=img.device),
                            torch.arange(w, dtype=img.dtype,
                                         device=img.device), indexing="ij")
    return _sample(img, torch.stack([xs + u, ys + v], dim=-1))


def _grad(img):
    """Forward differences (the TV operator; adjoint of _div)."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[..., :, :-1] = img[..., :, 1:] - img[..., :, :-1]
    gy[..., :-1, :] = img[..., 1:, :] - img[..., :-1, :]
    return gx, gy


def _grad_central(img):
    """Central differences for the IMAGE gradient (forward differences
    carry a half-pixel phase shift that biases the flow magnitude)."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[..., :, 1:-1] = 0.5 * (img[..., :, 2:] - img[..., :, :-2])
    gy[..., 1:-1, :] = 0.5 * (img[..., 2:, :] - img[..., :-2, :])
    return gx, gy


def _div(px, py):
    dx = px - torch.roll(px, 1, dims=-1)
    dx[..., :, 0] = px[..., :, 0]
    dy = py - torch.roll(py, 1, dims=-2)
    dy[..., 0, :] = py[..., 0, :]
    return dx + dy


def _tvl1_level(I0, I1, u, v, lam: float, theta: float, n_warps: int,
                n_iters: int, tau: float = 0.25):
    """``n_warps`` linearizations of I1 around the flow (u, v), each with
    ``n_iters`` primal-dual iterations. All [C, H, W]."""
    h, w = I0.shape[-2:]
    z = torch.zeros_like(u)
    p11, p12, p21, p22 = z, z, z, z
    lt = lam * theta
    taut = tau / theta
    for _ in range(n_warps):
        I1w, _ = _warp(I1, u, v)
        gx, gy = _grad_central(I1)
        I1wx, _ = _warp(gx, u, v)
        I1wy, _ = _warp(gy, u, v)
        rho_c = I1w - I0 - I1wx * u - I1wy * v
        grad2 = I1wx ** 2 + I1wy ** 2 + 1e-9
        th = lt * grad2
        for _ in range(n_iters):
            rho = rho_c + I1wx * u + I1wy * v
            d1 = torch.where(rho < -th, lt * I1wx,
                             torch.where(rho > th, -lt * I1wx,
                                         -rho * I1wx / grad2))
            d2 = torch.where(rho < -th, lt * I1wy,
                             torch.where(rho > th, -lt * I1wy,
                                         -rho * I1wy / grad2))
            u = (u + d1) + theta * _div(p11, p12)
            v = (v + d2) + theta * _div(p21, p22)
            ux, uy = _grad(u)
            vx, vy = _grad(v)
            p11 = p11 + taut * ux
            p12 = p12 + taut * uy
            n1 = torch.clamp(torch.sqrt(p11 ** 2 + p12 ** 2), min=1.0)
            p11, p12 = p11 / n1, p12 / n1
            p21 = p21 + taut * vx
            p22 = p22 + taut * vy
            n2 = torch.clamp(torch.sqrt(p21 ** 2 + p22 ** 2), min=1.0)
            p21, p22 = p21 / n2, p22 / n2
        u = torch.clamp(u, -w / 2, w / 2)
        v = torch.clamp(v, -h / 2, h / 2)
    return u, v


def tvl1_flow(img0: torch.Tensor, img1: torch.Tensor, n_levels: int = 3,
              lam: float = 0.15, theta: float = 0.3, n_warps: int = 3,
              n_iters: int = 20) -> torch.Tensor:
    """img0, img1: [C, H, W] in [0, 255], on the device the flow runs on.
    Returns the flow [C, H, W, 2] that maps img0's pixels to their
    positions in img1."""
    s0 = [img0 / 255.0]
    s1 = [img1 / 255.0]
    for _ in range(n_levels - 1):
        s0.append(downsample2(gaussian_blur(s0[-1])))
        s1.append(downsample2(gaussian_blur(s1[-1])))
    u = torch.zeros_like(s0[-1])
    v = torch.zeros_like(s0[-1])
    for lv in range(n_levels - 1, -1, -1):
        if lv < n_levels - 1:
            h, w = s0[lv].shape[-2:]
            hs, ws = u.shape[-2:]
            ys = torch.arange(h, device=u.device) * hs // h
            xs = torch.arange(w, device=u.device) * ws // w
            u = 2.0 * u[:, ys][:, :, xs]
            v = 2.0 * v[:, ys][:, :, xs]
        u, v = _tvl1_level(s0[lv], s1[lv], u, v, lam, theta, n_warps,
                           n_iters)
    return torch.stack([u, v], dim=-1)
