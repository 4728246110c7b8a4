"""Synthetic textured room with ground-truth trajectories (the port of
``coslam_tpu/io/synthetic.py``).

World = textured planes (floor, ceiling, back and side walls) plus
optional moving textured quads (the dynamic objects); rendering ray-casts
every pixel to the nearest plane and fetches its texture bilinearly. With
the same numpy generator the textures, rigs and trajectories equal the
JAX package's, so a run can make its own frames and ground truth on the
device it runs on. ``render_batch`` renders views in chunks of batched
calls; ``apply_distortion_warp`` turns ideal-pinhole renders into what a
lens with distortion coefficients kc captures.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from coslam_torch.geometry.camera import (normalized_to_pixel,
                                          pixel_to_normalized,
                                          undistort_normalized)
from coslam_torch.geometry.se3 import so3_exp_np
from coslam_torch.ops.image import gaussian_blur
from coslam_torch.ops.patches import sample_bilinear
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


class MovingQuad(NamedTuple):
    """A dynamic textured quad: position is a function of frame index."""
    center0: np.ndarray   # [3] at frame 0
    velocity: np.ndarray  # [3] per frame
    eu: np.ndarray        # [3]
    ev: np.ndarray        # [3]
    tex: np.ndarray


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
    # a pixel that hits no plane reads texel (0, 0) and is zeroed below:
    # its (a, b) on plane 0 may be NaN, which must not become an index
    zero = torch.zeros((), device=dev)
    a_best = torch.where(any_hit, torch.gather(a, 0, best[None])[0], zero)
    b_best = torch.where(any_hit, torch.gather(b, 0, best[None])[0], zero)
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


def _with_quads(planes: list[Plane], quads, device):
    """Plane tensors of the static planes followed by the quads (placed at
    frame 0), and the quads' velocities [Q, 3] (None without quads)."""
    if not quads:
        return _plane_tensors(planes, device), None
    qp = [Plane(q.center0 - 0.5 * q.eu - 0.5 * q.ev, q.eu, q.ev, q.tex)
          for q in quads]
    vel = torch.as_tensor(np.stack([q.velocity for q in quads])
                          .astype(np.float32), device=device)
    return _plane_tensors(planes + qp, device), vel


def render_sequence(planes, K, Rs, ts, h, w, quads=None, frames=None,
                    device=None) -> torch.Tensor:
    """Render B views: Rs [B, 3, 3], ts [B, 3] world->camera; ``frames``
    [B] is each view's frame index for the moving quads (default
    0..B-1). Quads occlude the static planes when closer. Returns
    [B, H, W] f32 (0..255) on ``device``."""
    dev = resolve_device(device)
    (p0, eu, ev, tex), vel = _with_quads(planes, quads, dev)
    Kt = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    Rt = torch.as_tensor(np.asarray(Rs, np.float32), device=dev)
    tt = torch.as_tensor(np.asarray(ts, np.float32), device=dev)
    B = Rt.shape[0]
    fr = np.arange(B) if frames is None else np.asarray(frames)
    out = []
    for b in range(B):
        p0b = p0
        if vel is not None:
            Q = vel.shape[0]
            p0b = torch.cat([p0[:-Q], p0[-Q:] + float(fr[b]) * vel])
        out.append(_render(p0b, eu, ev, tex, Kt, Rt[b], tt[b], h, w))
    return torch.stack(out)


def render_batch(planes, K, Rs, ts, h, w, quads=None, frames=None,
                 chunk: int = 8, device=None) -> torch.Tensor:
    """``render_sequence`` in chunks of ``chunk`` views, each chunk one
    batched call (``torch.func.vmap`` of the one-view renderer): Rs
    [B, 3, 3], ts [B, 3], ``frames`` [B] each view's frame index for the
    moving quads (default 0..B-1). The per-view [P, H, W, 3]
    intermediates bound the chunk. Returns [B, H, W] f32 on ``device``."""
    dev = resolve_device(device)
    (p0, eu, ev, tex), vel = _with_quads(planes, quads, dev)
    Kt = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    Rt = torch.as_tensor(np.asarray(Rs, np.float32), device=dev)
    tt = torch.as_tensor(np.asarray(ts, np.float32), device=dev)
    B = Rt.shape[0]
    fr = torch.as_tensor(np.arange(B) if frames is None
                         else np.asarray(frames), dtype=torch.float32,
                         device=dev)
    views = torch.func.vmap(_render, in_dims=(0, None, None, None, None, 0,
                                              0, None, None))
    out = []
    for s in range(0, B, chunk):
        e = min(s + chunk, B)
        p0b = p0.expand(e - s, *p0.shape)
        if vel is not None:
            Q = vel.shape[0]
            q0 = p0[-Q:] + fr[s:e, None, None] * vel           # [b, Q, 3]
            p0b = torch.cat([p0b[:, :-Q], q0], dim=1)
        out.append(views(p0b, eu, ev, tex, Kt, Rt[s:e], tt[s:e], h, w))
    return torch.cat(out)


def apply_distortion_warp(img: torch.Tensor, K, kc) -> torch.Tensor:
    """Turn an ideal-pinhole rendering [H, W] (or a batch [B, H, W]) into
    what a camera with distortion coefficients kc captures:
    I_d(p) = I_ideal(K D^-1(K^-1 p)), sampled bilinearly with clamped
    borders (``ops/patches.py::sample_bilinear``), on ``img``'s device."""
    dev = img.device
    Kt = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    kct = torch.as_tensor(np.asarray(kc, np.float32), device=dev)
    h, w = img.shape[-2:]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    p = torch.stack([xs, ys], dim=-1)
    src = normalized_to_pixel(
        undistort_normalized(pixel_to_normalized(p, Kt), kct), Kt)
    if img.dim() == 3:
        return torch.stack([sample_bilinear(im, src)[0] for im in img])
    return sample_bilinear(img, src)[0]


def render(planes: list[Plane], K: np.ndarray, R: np.ndarray, t: np.ndarray,
           h: int, w: int, quads=None, frame: int = 0,
           device=None) -> torch.Tensor:
    """Render one view (world->camera (R, t)) at ``frame`` (for the
    quads). Returns [H, W] f32 (0..255) on ``device``."""
    return render_sequence(planes, K, np.asarray(R)[None],
                           np.asarray(t)[None], h, w, quads=quads,
                           frames=[frame], device=device)[0]


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


def multi_cam_rig(n_cams: int, baseline: float = 0.8):
    """Static offsets of each camera from the rig center (world units),
    cameras side by side with slight toe-in. Returns (rotations [C, 3, 3],
    offsets [C, 3]), numpy."""
    offs, rots = [], []
    for ci in range(n_cams):
        x = (ci - (n_cams - 1) / 2.0) * baseline
        offs.append(np.array([x, 0.0, 0.0], dtype=np.float32))
        toe = -0.04 * (ci - (n_cams - 1) / 2.0)
        rots.append(so3_exp_np(np.array([0.0, toe, 0.0])))
    return np.stack(rots), np.stack(offs)


def rig_sequence(n_cams: int, n_frames: int, baseline: float = 1.0,
                 forward: float = 0.04):
    """Ground-truth poses of a camera rig flying ``orbit_trajectory``:
    (Rs [C, F, 3, 3], ts [C, F, 3]) world->camera, numpy."""
    Rr, tr = orbit_trajectory(n_frames, forward=forward)
    rot_c, offs_c = multi_cam_rig(n_cams, baseline=baseline)
    Rs = np.zeros((n_cams, n_frames, 3, 3), np.float32)
    ts = np.zeros((n_cams, n_frames, 3), np.float32)
    for f in range(n_frames):
        c_rig = -Rr[f].T @ tr[f]
        for c in range(n_cams):
            center = c_rig + Rr[f].T @ offs_c[c]
            Rc = rot_c[c] @ Rr[f]
            Rs[c, f] = Rc
            ts[c, f] = -Rc @ center
    return Rs, ts
