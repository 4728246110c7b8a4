"""The per-frame tracked step: pyramid -> KLT + redetect -> pose update ->
pose history -> (several cameras: dynamic-feature voting and map-point
classification) -> new map points -> lifecycle, as one function over the
camera batch (the port of ``coslam_tpu/slam/fused.py``). ``pack_stats``
flattens the per-frame statistics into one vector, so a tracked frame
costs one device-to-host copy.

With ``mesh`` (a ``parallel.mesh.CamMesh``) the step is the JAX package's
"shard pixels, replicate points": each camera block's pyramid, KLT and
corner refill and NCC blocks run on that block's device
(``ShardedPyramid.following``, ``shard_advance_tracks``), the block's track rows go there and come back
with its NCC blocks, and the rest of the step runs once, on
``mesh.main``. The frames come as one [C/n, H, W] tensor a shard, already
on its device, and the carried pyramid is a ``ShardedPyramid`` that stays
on the shards from frame to frame.

``frame_steps_scan`` runs a chunk of frames (the reference's
``lax.scan``: here a Python loop, enqueued with no host wait) and
``frame_steps_chunk`` appends the periodic host-decision scan to the
chunk's stats rows, so a chunk costs one copy too. Each takes ``mesh``.

The JAX step donates its state buffers; here each step returns new
tensors and the engine simply drops the old state. No step waits on the
host: every constant is a Python scalar, a device fill or a tensor kept on
the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from coslam_torch.config import SlamConfig
from coslam_torch.ops.ncc import extract_ncc_blocks_batched
from coslam_torch.ops.pyramid import Pyramid, build_pyramid
from coslam_torch.parallel.mesh import on_device
from coslam_torch.slam import steps
from coslam_torch.slam.classify import (classify_map_points,
                                        detect_dynamic_features)
from coslam_torch.slam.grouping import host_scan_device
from coslam_torch.slam.state import (PT_DYNAMIC, ST_ALIVE, SlamState,
                                     TrackTable)
from coslam_torch.spans import span
from coslam_torch.util import to_device


class FrameStats(NamedTuple):
    n_inliers: torch.Tensor   # [C]
    coverage: torch.Tensor    # [C]
    med_depth: torch.Tensor   # [C]
    med_err: torch.Tensor     # [C]
    n_new_points: torch.Tensor
    n_tracked: torch.Tensor   # [C]
    n_static: torch.Tensor    # scalar (0 for mono: classify is multicam)
    n_dynamic: torch.Tensor   # scalar
    n_mapped: torch.Tensor    # [C] tracked features bound to map points
    R: torch.Tensor           # [C, 3, 3] post-step poses
    t: torch.Tensor           # [C, 3]
    dyn_ids: torch.Tensor     # [D] map slots of alive dynamic points (-1)
    dyn_xyz: torch.Tensor     # [D, 3] their positions


class ShardedPyramid:
    """The carried pyramid of a mesh step: shard k's camera block's levels
    on ``mesh.devices[k]``, kept there from frame to frame, with what the
    block's step reads on that device besides: the frame the pyramid was
    built at (``frame``, 0-dim int32: the track-history ring index) and the
    block's intrinsics and distortion (``K``, ``kc``, moved once, with the
    first pyramid). ``level0`` gathers level 0 to main for the host
    cadence's readers, once per pyramid."""

    def __init__(self, mesh, pyrs, frame, K, kc):
        self.mesh = mesh
        self.pyrs = tuple(pyrs)
        self.frame = tuple(frame)
        self.K = tuple(K)
        self.kc = tuple(kc)
        self._level0 = None

    @property
    def n_levels(self) -> int:
        return self.pyrs[0].n_levels

    def following(self, imgs) -> "ShardedPyramid":
        """The next frame's carried pyramid: shard k's pyramid of
        ``imgs[k]`` ([C/n, H, W] on its device) built there, the frame one
        on."""
        pyrs, frames = [], []
        for k, dev in enumerate(self.mesh.devices):
            with on_device(dev):
                pyrs.append(build_pyramid(imgs[k].to(torch.float32),
                                          self.n_levels))
                frames.append(self.frame[k] + 1)
        return ShardedPyramid(self.mesh, pyrs, frames, self.K, self.kc)

    def level0(self) -> Pyramid:
        """Level 0 of every camera [C, H, W] on main, as a one-level
        ``Pyramid`` (the merge bridge, loop closure, the map init,
        inter-camera mapping and registration read only that level). One
        gather per pyramid; later calls return the same tensors."""
        if self._level0 is None:
            imgs = torch.cat(self.mesh.gather(
                [p.imgs[0] for p in self.pyrs], "pyr.imgs.0"))
            self._level0 = Pyramid(imgs=(imgs,), dxs=(), dys=())
        return self._level0

    def gather_levels(self) -> Pyramid:
        """Every level (and level 0's derivatives) of every camera on main,
        stacked over the cameras (a checkpoint's pyramid)."""
        def cat(get, leaf):
            return torch.cat(self.mesh.gather([get(p) for p in self.pyrs],
                                              leaf))
        return Pyramid(
            imgs=tuple(cat(lambda p, i=i: p.imgs[i], f"pyr.imgs.{i}")
                       for i in range(self.n_levels)),
            dxs=(cat(lambda p: p.dxs[0], "pyr.dxs.0"),),
            dys=(cat(lambda p: p.dys[0], "pyr.dys.0"),))


def build_sharded_pyramid(mesh, imgs, n_levels: int, frame: int, K, kc):
    """Each shard's pyramid of its frames (``imgs``: one [C/n, H, W] tensor
    a shard, on its device) built there: the carried pyramid of frame
    ``frame`` (a host integer, filled on each shard). ``K``, ``kc`` [C, ...]
    on main: each block's part goes to its shard."""
    pyrs, frames = [], []
    for img, dev in zip(imgs, mesh.devices):
        with on_device(dev):
            pyrs.append(build_pyramid(img.to(torch.float32), n_levels))
            frames.append(torch.full((), frame, dtype=torch.int32,
                                     device=dev))
    return ShardedPyramid(mesh, pyrs, frames, mesh.scatter(K, "K"),
                          mesh.scatter(kc, "kc"))


def shard_pyramid(mesh, pyr: Pyramid, frame: int, K, kc) -> ShardedPyramid:
    """A camera-stacked pyramid on main (a checkpoint's, another engine's)
    as the carried pyramid of frame ``frame`` of a mesh step: each block's
    levels to its shard."""
    imgs = [mesh.scatter(a, f"pyr.imgs.{i}") for i, a in enumerate(pyr.imgs)]
    dxs = mesh.scatter(pyr.dxs[0], "pyr.dxs.0")
    dys = mesh.scatter(pyr.dys[0], "pyr.dys.0")
    pyrs = [Pyramid(imgs=tuple(lv[k] for lv in imgs), dxs=(dxs[k],),
                    dys=(dys[k],)) for k in range(len(mesh))]
    frames = [torch.full((), frame, dtype=torch.int32, device=d)
              for d in mesh.devices]
    return ShardedPyramid(mesh, pyrs, frames, mesh.scatter(K, "K"),
                          mesh.scatter(kc, "kc"))


def shard_frames(mesh, images) -> list:
    """A frame's images [C, H, W] as one [C/n, H, W] tensor a shard, each
    on its device. Host arrays (numpy, CPU tensors) are copied to each
    shard directly, with no host wait; a tensor on a card goes through
    ``mesh.scatter``."""
    if torch.is_tensor(images) and images.device.type != "cpu":
        return mesh.scatter(images, "frames")
    images = torch.as_tensor(images)
    return [to_device(images[b], d) for b, d in
            zip(mesh.blocks(images.shape[0]), mesh.devices)]


def shard_advance_tracks(pyr_prev: ShardedPyramid, pyr_cur: ShardedPyramid,
                         tracks: TrackTable, cfg: SlamConfig,
                         blocks: bool = True):
    """KLT and corner refill (``advance_tracks``) of each camera block on
    its device and, with ``blocks``, the NCC blocks at the tracks' new
    positions there. The block's track rows go to its shard and come back,
    and the block pair comes back: 2 x 11 + 2 transfers a shard. Returns
    (the TrackTable on main, (blocks [C, N, B], ok [C, N]) on main or
    None)."""
    mesh = pyr_prev.mesh
    names = TrackTable._fields
    rows = [mesh.scatter(leaf, f"tracks.{name}")
            for name, leaf in zip(names, tracks)]
    outs = []
    for k, dev in enumerate(mesh.devices):
        with on_device(dev):
            tr = steps.advance_tracks(
                pyr_prev.pyrs[k], pyr_cur.pyrs[k],
                TrackTable(*[r[k] for r in rows]), pyr_prev.K[k],
                pyr_prev.kc[k], pyr_cur.frame[k], cfg)
            blk = extract_ncc_blocks_batched(
                pyr_cur.pyrs[k].imgs[0], tr.raw, cfg.p.ncc_patch_radius) \
                if blocks else None
        outs.append((tr, blk))

    def back(get, leaf):
        return torch.cat(mesh.gather([get(o) for o in outs], leaf))
    tracks = TrackTable(*[back(lambda o, i=i: o[0][i], f"tracks.{name}")
                          for i, name in enumerate(names)])
    if not blocks:
        return tracks, None
    return tracks, (back(lambda o: o[1][0], "ncc.blocks"),
                    back(lambda o: o[1][1], "ncc.ok"))


def frame_step(state: SlamState, pyr_prev, imgs_cur, K: torch.Tensor,
               kc: torch.Tensor, cfg: SlamConfig, mesh=None,
               large_err: bool = False):
    """One tracked frame. Returns (state', pyr_cur, FrameStats); the
    previous frame's pyramid is carried between calls. ``large_err``: the
    settle window after a merge or loop closure, where the realigned poses
    meet widened pose gates (the reference's largeErr frames). ``mesh``:
    the camera-sharded step (module docstring); ``imgs_cur`` is then one
    tensor a shard and ``pyr_prev`` a ShardedPyramid. Each stage runs in
    its span (``step.pyramid`` to ``step.stats``)."""
    ncc_blocks = None
    if mesh is None:
        imgs_cur = imgs_cur.to(torch.float32)
        img_hw = (imgs_cur.shape[1], imgs_cur.shape[2])
        with span("step.pyramid"):
            pyr_cur = build_pyramid(imgs_cur, cfg.klt.n_levels)
        with span("step.track"):
            tracks = steps.advance_tracks(pyr_prev, pyr_cur, state.tracks, K,
                                          kc, state.frame + 1, cfg)
    else:
        img_hw = (imgs_cur[0].shape[1], imgs_cur[0].shape[2])
        with span("step.pyramid"):
            pyr_cur = pyr_prev.following(imgs_cur)
        with span("step.track"):
            tracks, ncc_blocks = shard_advance_tracks(pyr_prev, pyr_cur,
                                                      state.tracks, cfg)
    dev = state.R.device
    state = state._replace(tracks=tracks, frame=state.frame + 1)
    with span("step.pose_update"):
        out = steps.pose_update(state, K, kc, img_hw, cfg,
                                large_err=large_err)
        state = state._replace(R=out.R, t=out.t, tracks=out.tracks,
                               mappts=out.mappts)
        state = steps.push_pose_history(state)
    with span("step.classify"):
        if cfg.num_cameras > 1:
            state = detect_dynamic_features(state, K, cfg)
            cls = classify_map_points(state, K, cfg)
            state = state._replace(mappts=cls.mappts, tracks=cls.tracks)
            n_static, n_dynamic = cls.n_static, cls.n_dynamic
        else:
            n_static = torch.zeros((), dtype=torch.int32, device=dev)
            n_dynamic = torch.zeros_like(n_static)
    with span("step.new_points"):
        mappts, tracks2, n_new = steps.new_map_points(
            state, pyr_cur, K, kc, cfg, blocks=ncc_blocks)
    with span("step.lifecycle"):
        mappts = steps.lifecycle_update(mappts, state.frame, cfg)
        state = state._replace(mappts=mappts, tracks=tracks2)
    with span("step.stats"):
        # dynamic snapshot (up to D slots) for the host-side trajectory log
        D = state.kfs.dyn_xyz.shape[1]
        P = mappts.xyz.shape[0]
        dyn = (mappts.status == ST_ALIVE) & (mappts.ptype == PT_DYNAMIC)
        pt_of_d = steps._rank_to_index(dyn)[:D]
        dyn_ids = torch.where(pt_of_d < P, pt_of_d, -1).to(torch.int32)
        dyn_xyz = mappts.xyz[torch.clamp(pt_of_d, 0, P - 1).long()]
        stats = FrameStats(
            n_inliers=out.n_inliers, coverage=out.coverage,
            med_depth=out.med_depth, med_err=out.med_err,
            n_new_points=n_new, n_tracked=torch.sum(tracks2.valid, dim=1),
            n_static=n_static, n_dynamic=n_dynamic,
            n_mapped=torch.sum(tracks2.valid & (tracks2.mpt >= 0), dim=1),
            R=state.R, t=state.t, dyn_ids=dyn_ids, dyn_xyz=dyn_xyz)
    return state, pyr_cur, stats


def pack_stats(fs: FrameStats) -> torch.Tensor:
    """Flatten FrameStats into ONE f32 vector (one device-to-host copy)."""
    f32 = torch.float32
    return torch.cat([
        fs.n_inliers.to(f32), fs.coverage.to(f32),
        fs.med_depth.to(f32), fs.med_err.to(f32),
        fs.n_new_points.reshape(1).to(f32), fs.n_tracked.to(f32),
        fs.n_static.reshape(1).to(f32), fs.n_dynamic.reshape(1).to(f32),
        fs.n_mapped.to(f32), fs.R.reshape(-1).to(f32),
        fs.t.reshape(-1).to(f32), fs.dyn_ids.to(f32),
        fs.dyn_xyz.reshape(-1).to(f32)])


def unpack_stats(v, C: int, D: int) -> FrameStats:
    """Host-side inverse of pack_stats (numpy fields)."""
    v = v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    o = 0

    def take(n, shape=None):
        nonlocal o
        out = v[o:o + n]
        o += n
        return out.reshape(shape) if shape else out

    return FrameStats(
        n_inliers=take(C), coverage=take(C), med_depth=take(C),
        med_err=take(C), n_new_points=take(1)[0], n_tracked=take(C),
        n_static=take(1)[0], n_dynamic=take(1)[0], n_mapped=take(C),
        R=take(9 * C, (C, 3, 3)), t=take(3 * C, (C, 3)),
        dyn_ids=take(D).astype(int), dyn_xyz=take(3 * D, (D, 3)))


def frame_step_packed(state: SlamState, pyr_prev, imgs_cur,
                      K: torch.Tensor, kc: torch.Tensor, cfg: SlamConfig,
                      mesh=None, large_err: bool = False):
    """``frame_step`` with its stats packed into one vector (the engine's
    per-frame path). Returns (state', pyr_cur, packed stats)."""
    state, pyr_cur, fs = frame_step(state, pyr_prev, imgs_cur, K, kc, cfg,
                                    mesh=mesh, large_err=large_err)
    return state, pyr_cur, pack_stats(fs)


def frame_steps_scan(state: SlamState, pyr_prev, imgs_seq, K: torch.Tensor,
                     kc: torch.Tensor, cfg: SlamConfig, mesh=None,
                     large_err: bool = False):
    """A chunk of frames, imgs_seq [F, C, H, W], through ``frame_step`` one
    after the other; the host cadence does not run inside the chunk. With
    ``mesh``, ``imgs_seq`` is one [F, C/n, H, W] tensor a shard, on its
    device. Returns (state', pyr_last, packed stats [F, S]: one
    ``pack_stats`` row per frame)."""
    n = imgs_seq[0].shape[0] if mesh is not None else imgs_seq.shape[0]
    rows = []
    for i in range(n):
        imgs = [s[i] for s in imgs_seq] if mesh is not None else imgs_seq[i]
        state, pyr_prev, fs = frame_step(state, pyr_prev, imgs, K, kc, cfg,
                                         mesh=mesh, large_err=large_err)
        rows.append(pack_stats(fs))
    return state, pyr_prev, torch.stack(rows)


def frame_steps_chunk(state: SlamState, pyr_prev, imgs_seq, K: torch.Tensor,
                      kc: torch.Tensor, cfg: SlamConfig, mesh=None,
                      large_err: bool = False):
    """``frame_steps_scan`` and the periodic host-decision scan
    (``grouping.host_scan_device`` after the last frame) in ONE flat vector,
    the chunked engine's one device-to-host copy per chunk. Returns
    (state', pyr_last, flat [F * S + C * (3C + 2)]: the stats rows row-major,
    then the scan block)."""
    state, pyr_prev, stats = frame_steps_scan(state, pyr_prev, imgs_seq, K,
                                              kc, cfg, mesh=mesh,
                                              large_err=large_err)
    scan = host_scan_device(state, K, cfg.image_height, cfg.image_width,
                            cfg.p.loop_dormant_age)
    flat = torch.cat([stats.reshape(-1),
                      scan.reshape(-1).to(torch.float32)])
    return state, pyr_prev, flat
