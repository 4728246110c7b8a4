"""Scaling and transfer census of the camera-sharded step (the port of
``coslam_tpu/parallel/scaling.py``).

- ``step_scaling``: the time of the camera-sharded fused step on meshes of
  different sizes (strong scaling: the cameras fixed, the devices more).
  On a card each row is CUDA events around ``iters`` steps, ending in a
  sync; on the CPU the host clock (a CPU mesh runs its shards one after
  the other, so there its rows only show that the harness runs).
- ``audit_step_transfers``: the port's counterpart of
  ``audit_step_collectives``. The JAX package counts the collectives in
  the step's optimized HLO; the port's mesh counts every tensor it moves
  between its devices (``CamMesh.census``), here over one mesh step. The
  contract is the JAX package's "one boundary gather set": each shard
  receives its track rows once and returns its track rows and one NCC
  block pair once, and nothing else moves.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from coslam_torch.config import CapacityConfig, KLTConfig, SlamConfig
from coslam_torch.ops.corners import detect_corners
from coslam_torch.ops.image import gaussian_blur
from coslam_torch.ops.pyramid import build_pyramid
from coslam_torch.parallel.mesh import make_cam_mesh, shard_state
from coslam_torch.slam import steps
from coslam_torch.slam.fused import frame_step, shard_frames, shard_pyramid
from coslam_torch.slam.state import init_state


def mesh_cfg(n_cams: int, h: int, w: int, feats: int) -> SlamConfig:
    """The JAX package's mesh test configuration."""
    return SlamConfig(
        num_cameras=n_cams, image_height=h, image_width=w,
        klt=KLTConfig(n_levels=3, min_cornerness=10.0),
        cap=CapacityConfig(max_features=feats, max_map_points=1024,
                           max_keyframes=8, ba_window=4))


def step_inputs(cfg: SlamConfig, mesh, rng):
    """(state, pyr_prev, imgs_cur, K, kc) of one mesh step, as the JAX
    package's dry run makes them: blurred uniform noise from ``rng``, the
    current frame the previous one rolled a pixel to the right, and the
    track table seeded with the previous frame's corners. The state and
    K, kc on ``mesh.main``; the carried pyramid and the current frame on
    the shards."""
    C, h, w = cfg.num_cameras, cfg.image_height, cfg.image_width
    main = mesh.main
    imgs = gaussian_blur(torch.from_numpy(
        rng.uniform(0, 255, (C, h, w)).astype(np.float32)))
    K = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        np.array([[120.0, 0, w / 2], [0, 120.0, h / 2], [0, 0, 1]],
                 dtype=np.float32), (C, 3, 3)))).to(main)
    kc = torch.zeros((C, 5), dtype=torch.float32, device=main)
    state = shard_state(init_state(cfg, "cpu"), mesh)
    pyr0 = build_pyramid(imgs.to(main), cfg.klt.n_levels)
    det = detect_corners(pyr0.imgs[0], pyr0.dxs[0], pyr0.dys[0], cfg.klt,
                         cfg.cap.max_features)
    tracks = steps.seed_tracks(
        state.tracks, det.pos, det.valid,
        torch.full(det.valid.shape, -1, dtype=torch.int32, device=main),
        K, kc, state.frame)
    pyr_prev = shard_pyramid(mesh, pyr0, 0, K, kc)
    imgs_cur = shard_frames(mesh, torch.roll(imgs, 1, dims=-1))
    return state._replace(tracks=tracks), pyr_prev, imgs_cur, K, kc


def step_scaling(device_counts=(1, 2, 4, 8), n_cams=8, h=96, w=128,
                 feats=128, iters=10, verbose=False,
                 devices=None) -> list[dict]:
    """Time the fused step with ``n_cams`` cameras sharded over the first
    1, 2, ... of ``devices`` (default: the visible cards). Returns one row
    a mesh size: {n_devices, step_ms, speedup_vs_1, efficiency}."""
    cfg = mesh_cfg(n_cams, h, w, feats)
    rng = np.random.default_rng(0)
    rows = []
    t1 = None
    for nd in device_counts:
        if n_cams % nd:
            raise ValueError("cameras must divide the mesh")
        mesh = make_cam_mesh(nd, devices=devices)
        state, pyr, imgs_cur, K, kc = step_inputs(cfg, mesh, rng)
        state, pyr, stats = frame_step(state, pyr, imgs_cur, K, kc, cfg,
                                       mesh=mesh)
        stats.n_tracked.cpu()                     # warm and wait once
        on_card = mesh.main.type == "cuda"
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(mesh.main))
        t0 = time.perf_counter()
        for _ in range(iters):
            state, pyr, stats = frame_step(state, pyr, imgs_cur, K, kc, cfg,
                                           mesh=mesh)
        if on_card:
            end.record(torch.cuda.current_stream(mesh.main))
            end.synchronize()
            ms = start.elapsed_time(end) / iters
        else:
            state.frame.item()
            ms = (time.perf_counter() - t0) / iters * 1e3
        if t1 is None:
            # the reference time: the 1-device row, or the smallest mesh
            # scaled to its device count when 1 is not measured
            t1 = ms * nd
        rows.append({
            "n_devices": nd,
            "step_ms": round(ms, 3),
            "speedup_vs_1": round(t1 / ms, 3),
            "efficiency": round(t1 / ms / nd, 3),
        })
        if verbose:
            print(f"[scaling] {nd} devices: {ms:.2f} ms/step "
                  f"(speedup {t1 / ms:.2f}x, eff {t1 / ms / nd:.2f})",
                  flush=True)
    return rows


def audit_step_transfers(n_devices=8, h=96, w=128, feats=128,
                         devices=None) -> dict:
    """The mesh's transfers over ONE fused step with one camera a device:
    {(direction, leaf): count}, direction "to_shard" or "to_main"."""
    cfg = mesh_cfg(n_devices, h, w, feats)
    mesh = make_cam_mesh(n_devices, devices=devices)
    state, pyr, imgs_cur, K, kc = step_inputs(cfg, mesh,
                                              np.random.default_rng(0))
    mesh.reset_census()
    frame_step(state, pyr, imgs_cur, K, kc, cfg, mesh=mesh)
    return dict(mesh.census)
