"""The benchmark's scenes: a frozen copy of coslam_torch's synthetic room.

A box room of blurred-noise textures, an optional moving textured quad,
and a rig of cameras side by side flying an orbit inside it; every pixel
is ray-cast to the nearest plane and its texel fetched bilinearly, with
plain torch ops on the device it is given (the port's
``io/synthetic.py`` at commit 9ecae9a, whose images it equals for the
same generator; ``slambench/tests/test_slambench_scene.py`` holds it
so). The traffic file fixes the motion; ``--seed`` draws the textures
only, so every seed gives the same sizes, motion and feed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slambench.reference.frozen.geometry.se3 import so3_exp_np
from slambench.reference.frozen.ops.image import gaussian_blur


class Plane(NamedTuple):
    p0: np.ndarray      # [3] origin corner
    eu: np.ndarray      # [3] u edge (full extent)
    ev: np.ndarray      # [3] v edge
    tex: np.ndarray     # [Ht, Wt] f32 texture (0..255)


class MovingQuad(NamedTuple):
    center0: np.ndarray   # [3] at frame 0
    velocity: np.ndarray  # [3] per frame
    eu: np.ndarray
    ev: np.ndarray
    tex: np.ndarray


def make_texture(rng, ht=256, wt=256, blur=1, contrast=255.0) -> np.ndarray:
    """Blurred uniform noise rescaled to [0, contrast]."""
    t = torch.from_numpy(rng.uniform(0, 1, (1, ht, wt)).astype(np.float32))
    for _ in range(blur):
        t = gaussian_blur(t)
    t = t - t.min()
    t = t / (t.max() + 1e-9) * contrast
    return t[0].numpy()


def make_room(rng, size=10.0) -> list[Plane]:
    """Floor, ceiling, back wall, left and right walls."""
    s = size
    return [
        Plane(np.array([-s, s / 2, 0.0]), np.array([2 * s, 0, 0]),
              np.array([0, 0, 2 * s]), make_texture(rng)),
        Plane(np.array([-s, -s / 2, 0.0]), np.array([2 * s, 0, 0]),
              np.array([0, 0, 2 * s]), make_texture(rng)),
        Plane(np.array([-s, -s / 2, 2 * s]), np.array([2 * s, 0, 0]),
              np.array([0, s, 0]), make_texture(rng)),
        Plane(np.array([-s, -s / 2, 0.0]), np.array([0, 0, 2 * s]),
              np.array([0, s, 0]), make_texture(rng)),
        Plane(np.array([s, -s / 2, 0.0]), np.array([0, 0, 2 * s]),
              np.array([0, s, 0]), make_texture(rng)),
    ]


def orbit(n_frames: int, forward=0.04, yaw_rate=0.003, sweep=1.5,
          sweep_rate=0.02, bob=0.02, bob_rate=0.1):
    """The rig's path: yaw ``yaw_rate`` a frame, centre (sweep sin(sweep_rate
    f), bob sin(bob_rate f), forward f). Returns world->camera (Rs [F,3,3],
    ts [F,3]), numpy (the port's ``orbit_trajectory`` at its defaults)."""
    Rs, ts = [], []
    for f in range(n_frames):
        R = so3_exp_np(np.array([0.0, yaw_rate * f, 0.0]))
        c = np.array([sweep * np.sin(sweep_rate * f), bob * np.sin(bob_rate * f),
                      forward * f], dtype=np.float32)
        Rs.append(R)
        ts.append((-R @ c).astype(np.float32))
    return np.stack(Rs), np.stack(ts)


def rig(n_cams: int, baseline: float):
    """Each camera's rotation and offset from the rig centre: side by
    side, slight toe-in. Returns (rotations [C,3,3], offsets [C,3])."""
    offs, rots = [], []
    for ci in range(n_cams):
        x = (ci - (n_cams - 1) / 2.0) * baseline
        offs.append(np.array([x, 0.0, 0.0], dtype=np.float32))
        toe = -0.04 * (ci - (n_cams - 1) / 2.0)
        rots.append(so3_exp_np(np.array([0.0, toe, 0.0])))
    return np.stack(rots), np.stack(offs)


def rig_poses(n_cams: int, n_frames: int, baseline: float, motion: dict):
    """Ground truth of every camera: (Rs [F, C, 3, 3], ts [F, C, 3])."""
    Rr, tr = orbit(n_frames, **motion)
    rot_c, offs_c = rig(n_cams, baseline)
    Rs = np.zeros((n_frames, n_cams, 3, 3), np.float32)
    ts = np.zeros((n_frames, n_cams, 3), np.float32)
    for f in range(n_frames):
        c_rig = -Rr[f].T @ tr[f]
        for c in range(n_cams):
            center = c_rig + Rr[f].T @ offs_c[c]
            Rs[f, c] = rot_c[c] @ Rr[f]
            ts[f, c] = -Rs[f, c] @ center
    return Rs, ts


def _render(p0, eu, ev, tex, K, R, t, h: int, w: int) -> torch.Tensor:
    npl, ht, wt = tex.shape
    dev = p0.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    d_cam = torch.stack([(xs - cx) / fx, (ys - cy) / fy,
                         torch.ones_like(xs)], -1)
    d_world = torch.einsum("ji,hwj->hwi", R, d_cam)
    c = -torch.einsum("ji,j->i", R, t)
    n = torch.cross(eu, ev, dim=-1)
    denom = torch.einsum("pi,hwi->phw", n, d_world)
    num = torch.sum(n * (p0 - c[None, :]), -1)
    tt = num[:, None, None] / torch.where(torch.abs(denom) < 1e-9,
                                          torch.full_like(denom, 1e-9), denom)
    hit = c + tt[..., None] * d_world[None]
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
    best = torch.argmin(dist, dim=0)
    any_hit = torch.isfinite(torch.amin(dist, dim=0))
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


def render_batch(planes, K, Rs, ts, h, w, quads=(), frames=None,
                 chunk: int = 8, device="cpu") -> torch.Tensor:
    """Render views Rs [B,3,3], ts [B,3] (``frames`` [B]: each view's frame
    for the quads) in batched chunks of ``chunk`` views. Returns [B, H, W]
    float32 (0..255) on ``device``."""
    quads = list(quads)
    allp = planes + [Plane(q.center0 - 0.5 * q.eu - 0.5 * q.ev, q.eu, q.ev,
                           q.tex) for q in quads]

    def f(a):
        return torch.as_tensor(np.stack(a).astype(np.float32), device=device)

    p0, eu, ev, tex = (f([p.p0 for p in allp]), f([p.eu for p in allp]),
                       f([p.ev for p in allp]), f([p.tex for p in allp]))
    Kt = torch.as_tensor(np.asarray(K, np.float32), device=device)
    Rt = torch.as_tensor(np.asarray(Rs, np.float32), device=device)
    tt = torch.as_tensor(np.asarray(ts, np.float32), device=device)
    B = Rt.shape[0]
    fr = torch.as_tensor(np.arange(B) if frames is None
                         else np.asarray(frames), dtype=torch.float32,
                         device=device)
    views = torch.func.vmap(_render, in_dims=(0, None, None, None, None, 0,
                                              0, None, None))
    out = []
    for s in range(0, B, chunk):
        e = min(s + chunk, B)
        p0b = p0.expand(e - s, *p0.shape)
        if quads:
            Q = len(quads)
            vel = f([q.velocity for q in quads])
            q0 = p0[-Q:] + fr[s:e, None, None] * vel
            p0b = torch.cat([p0b[:, :-Q], q0], dim=1)
        out.append(views(p0b, eu, ev, tex, Kt, Rt[s:e], tt[s:e], h, w))
    return torch.cat(out)


def intrinsics(cfg: dict) -> np.ndarray:
    """K [C, 3, 3] of a configuration file."""
    f = float(cfg["focal"])
    cx, cy = cfg["principal_point"]
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float32)
    return np.broadcast_to(K, (cfg["num_cameras"], 3, 3)).copy()


def render_scene(cfg: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """Every frame of a cell: uint8 [F, C, H, W] on ``device``. The
    generator is seeded with ``seed``; it draws the room's five textures,
    then each quad's."""
    sc = traffic["scene"]
    C, H, W = cfg["num_cameras"], cfg["image_height"], cfg["image_width"]
    F = traffic["frames"]
    rng = np.random.default_rng(seed % 2 ** 64)
    planes = make_room(rng, size=sc["room_size"])
    quads = [MovingQuad(center0=np.asarray(q["center0"], np.float32),
                        velocity=np.asarray(q["velocity"], np.float32),
                        eu=np.array([q["size"][0], 0, 0], np.float32),
                        ev=np.array([0, q["size"][1], 0], np.float32),
                        tex=make_texture(rng)) for q in sc["quads"]]
    Rs, ts = rig_poses(C, F, sc["baseline"], sc["motion"])
    fidx = np.repeat(np.arange(F), C)
    out = torch.empty((F * C, H, W), dtype=torch.uint8, device=device)
    step = 4 * C
    K = intrinsics(cfg)[0]
    Rf, tf = Rs.reshape(-1, 3, 3), ts.reshape(-1, 3)
    for s in range(0, F * C, 64 * C):
        e = min(s + 64 * C, F * C)
        imgs = render_batch(planes, K, Rf[s:e], tf[s:e], H, W, quads=quads,
                            frames=fidx[s:e], chunk=step, device=device)
        out[s:e] = torch.clamp(imgs, 0, 255).to(torch.uint8)
    return out.reshape(F, C, H, W)
