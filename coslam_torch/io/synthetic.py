"""Synthetic textured room with ground-truth trajectories (the port of the
static-scene part of ``coslam_tpu/io/synthetic.py``).

World = textured planes (floor, ceiling, back and side walls); rendering
ray-casts every pixel to the nearest plane and fetches its texture
bilinearly. With the same numpy generator the textures and trajectories
equal the JAX package's, so a run can make its own frames and ground
truth on the device it runs on.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from coslam_torch.geometry.se3 import so3_exp_np
from coslam_torch.ops.image import gaussian_blur
from coslam_torch.util import resolve_device


class Plane(NamedTuple):
    p0: np.ndarray      # [3] origin corner
    eu: np.ndarray      # [3] u edge (full extent)
    ev: np.ndarray      # [3] v edge
    tex: np.ndarray     # [Ht, Wt] f32 texture (0..255)


def make_texture(rng, ht=256, wt=256, blur=1, contrast=255.0) -> np.ndarray:
    """Blurred uniform noise rescaled to [0, contrast] (computed on the
    CPU: textures are set-up data)."""
    t = torch.from_numpy(rng.uniform(0, 1, (1, ht, wt)).astype(np.float32))
    for _ in range(blur):
        t = gaussian_blur(t)
    t = t - t.min()
    t = t / (t.max() + 1e-9) * contrast
    return t[0].numpy()


def make_room(rng, size=10.0, tex_kw=None) -> list[Plane]:
    """A box room: floor, ceiling, back wall, left/right walls."""
    s = size
    tex_kw = tex_kw or {}

    def T():
        return make_texture(rng, **tex_kw)

    return [
        Plane(np.array([-s, s / 2, 0.0]), np.array([2 * s, 0, 0]),
              np.array([0, 0, 2 * s]), T()),               # floor y = +s/2
        Plane(np.array([-s, -s / 2, 0.0]), np.array([2 * s, 0, 0]),
              np.array([0, 0, 2 * s]), T()),               # ceiling
        Plane(np.array([-s, -s / 2, 2 * s]), np.array([2 * s, 0, 0]),
              np.array([0, s, 0]), T()),                   # back wall z = 2s
        Plane(np.array([-s, -s / 2, 0.0]), np.array([0, 0, 2 * s]),
              np.array([0, s, 0]), T()),                   # left wall
        Plane(np.array([s, -s / 2, 0.0]), np.array([0, 0, 2 * s]),
              np.array([0, s, 0]), T()),                   # right wall
    ]


def _plane_tensors(planes: list[Plane], device):
    def f(a):
        return torch.as_tensor(np.stack(a).astype(np.float32), device=device)
    return (f([p.p0 for p in planes]), f([p.eu for p in planes]),
            f([p.ev for p in planes]), f([p.tex for p in planes]))


def _render(p0, eu, ev, tex, K, R, t, h: int, w: int) -> torch.Tensor:
    npl, ht, wt = tex.shape
    dev = p0.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    d_cam = torch.stack([(xs - cx) / fx, (ys - cy) / fy,
                         torch.ones_like(xs)], -1)
    d_world = torch.einsum("ji,hwj->hwi", R, d_cam)       # R^T d
    c = -torch.einsum("ji,j->i", R, t)                     # camera center
    n = torch.cross(eu, ev, dim=-1)                        # [P, 3]
    denom = torch.einsum("pi,hwi->phw", n, d_world)
    num = torch.sum(n * (p0 - c[None, :]), -1)
    tt = num[:, None, None] / torch.where(torch.abs(denom) < 1e-9,
                                          torch.full_like(denom, 1e-9), denom)
    hit = c + tt[..., None] * d_world[None]                # [P, H, W, 3]
    rel = hit - p0[:, None, None, :]
    g11 = torch.sum(eu * eu, -1)[:, None, None]
    g12 = torch.sum(eu * ev, -1)[:, None, None]
    g22 = torch.sum(ev * ev, -1)[:, None, None]
    r1 = torch.einsum("phwi,pi->phw", rel, eu)
    r2 = torch.einsum("phwi,pi->phw", rel, ev)
    det = g11 * g22 - g12 * g12
    a = (g22 * r1 - g12 * r2) / det
    b = (g11 * r2 - g12 * r1) / det
    inside = (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1) & (tt > 1e-3)
    dist = torch.where(inside, tt, torch.full_like(tt, float("inf")))
    best = torch.argmin(dist, dim=0)                       # [H, W]
    any_hit = torch.isfinite(torch.amin(dist, dim=0))
    a_best = torch.gather(a, 0, best[None])[0]
    b_best = torch.gather(b, 0, best[None])[0]
    u = torch.clamp(a_best * (wt - 1), 0.0, wt - 1.001)
    v = torch.clamp(b_best * (ht - 1), 0.0, ht - 1.001)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    fu = u - u0
    fv = v - v0
    tex_flat = tex.reshape(-1)
    base = best * (ht * wt) + v0 * wt + u0
    v00 = tex_flat[base]
    v01 = tex_flat[base + 1]
    v10 = tex_flat[base + wt]
    v11 = tex_flat[base + wt + 1]
    val = (v00 * (1 - fu) * (1 - fv) + v01 * fu * (1 - fv)
           + v10 * (1 - fu) * fv + v11 * fu * fv)
    return torch.where(any_hit, val, torch.zeros_like(val))


def render(planes: list[Plane], K: np.ndarray, R: np.ndarray, t: np.ndarray,
           h: int, w: int, device=None) -> torch.Tensor:
    """Render one view (world->camera (R, t)). Returns [H, W] f32 (0..255)
    on ``device``."""
    dev = resolve_device(device)
    p0, eu, ev, tex = _plane_tensors(planes, dev)

    def T(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return _render(p0, eu, ev, tex, T(K), T(R), T(t), h, w)


def render_sequence(planes, K, Rs, ts, h, w, device=None) -> torch.Tensor:
    """Render a whole trajectory: [F, H, W] f32 on ``device``."""
    dev = resolve_device(device)
    p0, eu, ev, tex = _plane_tensors(planes, dev)
    Kt = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    Rt = torch.as_tensor(np.asarray(Rs, np.float32), device=dev)
    tt = torch.as_tensor(np.asarray(ts, np.float32), device=dev)
    return torch.stack([_render(p0, eu, ev, tex, Kt, Rt[f], tt[f], h, w)
                        for f in range(Rt.shape[0])])


def orbit_trajectory(n_frames: int, radius: float = 1.5,
                     forward: float = 0.04, yaw_rate: float = 0.003,
                     bob: float = 0.02):
    """Smooth single-camera trajectory inside the room looking at the back
    wall: forward motion + yaw + vertical bob. Returns (Rs [F,3,3],
    ts [F,3]) world->camera, numpy."""
    Rs, ts = [], []
    for f in range(n_frames):
        R = so3_exp_np(np.array([0.0, yaw_rate * f, 0.0]))
        c = np.array([radius * np.sin(0.02 * f), bob * np.sin(0.1 * f),
                      forward * f], dtype=np.float32)
        Rs.append(R)
        ts.append((-R @ c).astype(np.float32))
    return np.stack(Rs), np.stack(ts)
