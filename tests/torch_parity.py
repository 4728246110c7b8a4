"""Shared inputs for the parity tests of ``coslam_torch`` against
``coslam_tpu`` (``tests/test_torch_*.py``).

Both packages see the same numpy arrays. JAX state crosses over as numpy
leaves (``state_from_numpy``); pyramids cross level by level. JAX is
imported only by the helpers that run it, so the tests that need the card
(run where JAX is not installed) can use this module too.
"""

from __future__ import annotations

import numpy as np
import torch

from coslam_torch.ops.pyramid import Pyramid as TPyramid

H, W = 150, 200
KMAT = np.array([[[180.0, 0, 100], [0, 180.0, 75], [0, 0, 1]]], np.float32)
KC = np.zeros((1, 5), np.float32)

# the suite runs in several worker processes at once: keep each one's
# intra-op thread pool small
torch.set_num_threads(min(2, torch.get_num_threads()))


def to_numpy(tree):
    """Every leaf of a JAX pytree as a fresh numpy array (a copy: the JAX
    engine donates its state buffers to the next frame)."""
    import jax
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def t(a):
    """numpy -> CPU tensor (a copy)."""
    return torch.from_numpy(np.array(a, copy=True))


def n(x):
    """tensor or JAX array -> numpy."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pyramid_to_torch(pyr) -> TPyramid:
    """A JAX Pyramid (or one with numpy leaves) as the port's Pyramid."""
    return TPyramid(imgs=tuple(t(np.asarray(a)) for a in pyr.imgs),
                    dxs=tuple(t(np.asarray(a)) for a in pyr.dxs),
                    dys=tuple(t(np.asarray(a)) for a in pyr.dys))


def smooth_texture(rng, h, w, passes=2):
    """Trackable smooth random texture in [0, 255], [1, h, w] f32, made in
    numpy (the same [1 4 6 4 1]/16 edge-replicated blur as ops/image.py)."""
    img = rng.uniform(0, 1, (h, w)).astype(np.float64)
    k = np.array([1, 4, 6, 4, 1], np.float64) / 16
    for _ in range(passes):
        p = np.pad(img, 2, mode="edge")
        img = sum(k[i] * p[i:i + h, 2:2 + w] for i in range(5))
        p = np.pad(img, 2, mode="edge")
        img = sum(k[i] * p[2:2 + h, i:i + w] for i in range(5))
    img = (img - img.min()) / (img.max() - img.min() + 1e-12) * 255.0
    return img.astype(np.float32)[None]


def shift_image(img, dx, dy):
    """Bilinear shift of [1, h, w] by (dx, dy): content moves by +d."""
    _, h, w = img.shape
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    x, y = xs - dx, ys - dy
    x0 = np.clip(np.floor(x).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(int), 0, h - 2)
    fx, fy = x - x0, y - y0
    im = img[0].astype(np.float64)
    out = (im[y0, x0] * (1 - fx) * (1 - fy) + im[y0, x0 + 1] * fx * (1 - fy)
           + im[y0 + 1, x0] * (1 - fx) * fy + im[y0 + 1, x0 + 1] * fx * fy)
    return out.astype(np.float32)[None]


def render_mono_frames(n_frames: int, forward: float = 0.06):
    """Frames of the synthetic room rendered by the JAX package (seed 0),
    with their ground-truth poses."""
    from coslam_tpu.io.synthetic import (make_room, orbit_trajectory,
                                         render_sequence)
    rng = np.random.default_rng(0)
    planes = make_room(rng, size=10.0)
    Rs, ts = orbit_trajectory(n_frames, forward=forward)
    frames = np.asarray(render_sequence(planes, KMAT[0], Rs, ts, H, W))
    return frames, Rs, ts


def run_jax_engine(frames, snapshots=()):
    """Drive the JAX engine over ``frames`` at small_test_config(1, H, W).
    Returns a dict: the engine's host logs, its corrected trajectory and,
    for each frame k in ``snapshots``, (state, pyr_prev) as numpy trees
    right after frame k was processed."""
    from coslam_tpu.config import small_test_config
    from coslam_tpu.slam.pipeline import CoSlamEngine
    cfg = small_test_config(num_cameras=1, h=H, w=W)
    eng = CoSlamEngine(cfg, KMAT, KC)
    snaps = {}
    for f in range(frames.shape[0]):
        eng.process_frame(frames[f][None])
        if f in snapshots:
            snaps[f] = (to_numpy(eng.state), to_numpy(eng.pyr_prev))
    Rs, ts = eng.trajectory(0, correct=True)
    return dict(snaps=snaps, kf_frames=list(eng.kf_frames),
                boot_frame=boot_frame(eng.stats_log),
                traj=(np.asarray(Rs), np.asarray(ts)),
                stats_log=eng.stats_log)


def boot_frame(stats_log):
    """The frame at which the engine's bootstrap succeeded (None if never)."""
    for s in stats_log:
        if s.get("bootstrap"):
            return s["frame"]
    return None
