"""Fixed-capacity SoA SLAM state (the port of ``coslam_tpu/slam/state.py``).

The same NamedTuples, field names, shapes and dtypes as the JAX package,
as torch tensors: feature/track slots [C, N], map-point slots [P],
rolling history rings [C, T, N] and [C, TL, N], and a keyframe ring [KF].
``state_from_numpy``/``state_to_numpy`` carry a state across from the JAX
package (numpy leaves) and back.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from coslam_torch.config import SlamConfig
from coslam_torch.util import resolve_device

# map-point lifecycle status
ST_FREE = 0
ST_ALIVE = 1
ST_FALSE = 2      # classified false -> slot reclaimable

# map-point type (MapPoint type machine, SL_MapPoint.h:87-119)
PT_STATIC = 0
PT_DYNAMIC = 1
PT_UNCERTAIN = 2

# sampling stride (frames) of the long-horizon history ring
LONG_STRIDE = 3


class TrackTable(NamedTuple):
    """KLT slot table + rolling 2D history (dense per-frame ring and a
    coarse long-horizon ring sampled every ``LONG_STRIDE`` frames)."""

    pos: torch.Tensor        # [C, N, 2] undistorted px (SLAM space)
    raw: torch.Tensor        # [C, N, 2] distorted px (tracker space)
    valid: torch.Tensor      # [C, N] bool
    age: torch.Tensor        # [C, N] i32 frames tracked
    gain: torch.Tensor       # [C, N]
    mpt: torch.Tensor        # [C, N] i32 bound map slot, -1 = unmapped
    dyn_votes: torch.Tensor  # [C, N] i32 epipolar-violation votes
    hist: torch.Tensor       # [C, T, N, 2] undistorted history ring
    hist_valid: torch.Tensor  # [C, T, N]
    hist_long: torch.Tensor   # [C, TL, N, 2] every-LONG_STRIDE-frames ring
    hist_long_valid: torch.Tensor  # [C, TL, N]


class MapPoints(NamedTuple):
    xyz: torch.Tensor         # [P, 3]
    cov: torch.Tensor         # [P, 3, 3]
    gen: torch.Tensor         # [P] i32 slot generation (bumped on realloc)
    status: torch.Tensor      # [P] i32 (ST_*)
    ptype: torch.Tensor       # [P] i32 (PT_*)
    first_frame: torch.Tensor  # [P] i32
    last_obs: torch.Tensor    # [P] i32 last frame with any observation
    bad_votes: torch.Tensor   # [P] i32 consecutive classification failures
    moved_votes: torch.Tensor  # [P] i32 consecutive moved-detection frames
    owner: torch.Tensor       # [P] i32 camera id of most recent observation
    ncc: torch.Tensor         # [P, C, B] per-camera appearance blocks
    ncc_valid: torch.Tensor   # [P, C]


class KeyframeStore(NamedTuple):
    """Ring of keyframes with per-slot observation snapshots, plus the
    per-keyframe dynamic-point snapshots the BA window treats as
    independent landmarks."""

    frame: torch.Tensor    # [KF] i32, -1 = empty
    R: torch.Tensor        # [KF, C, 3, 3]
    t: torch.Tensor        # [KF, C, 3]
    obs_pos: torch.Tensor  # [KF, C, N, 2] undistorted px at the keyframe
    obs_mpt: torch.Tensor  # [KF, C, N] i32 map binding at the keyframe
    obs_gen: torch.Tensor  # [KF, C, N] i32 map-slot generation at snapshot
    dyn_xyz: torch.Tensor     # [KF, D, 3] dynamic-point snapshot positions
    dyn_obs_px: torch.Tensor  # [KF, C, D, 2] their per-camera observations
    dyn_obs_ok: torch.Tensor  # [KF, C, D]
    n: torch.Tensor        # scalar i32: total keyframes ever written


class SlamState(NamedTuple):
    frame: torch.Tensor        # scalar i32
    R: torch.Tensor            # [C, 3, 3] current world->camera
    t: torch.Tensor            # [C, 3]
    tracks: TrackTable
    mappts: MapPoints
    kfs: KeyframeStore
    pose_hist_R: torch.Tensor  # [C, T, 3, 3] ring aligned with tracks.hist
    pose_hist_t: torch.Tensor  # [C, T, 3]
    pose_hist_long_R: torch.Tensor  # [C, TL, 3, 3] aligned with hist_long
    pose_hist_long_t: torch.Tensor  # [C, TL, 3]
    group_id: torch.Tensor     # [C] i32 camera-group assignment


def history_len(cfg: SlamConfig) -> int:
    return max(cfg.p.min_feat_track_len + 1, 8)


def long_history_len(cfg: SlamConfig) -> int:
    """Slots in the long-horizon ring: LONG_STRIDE * TL spans the
    classify window."""
    return max(-(-cfg.p.classify_frame_window // LONG_STRIDE), 1)


def init_state(cfg: SlamConfig, device=None) -> SlamState:
    C = cfg.num_cameras
    N = cfg.cap.max_features
    P = cfg.cap.max_map_points
    KF = cfg.cap.max_keyframes
    T = history_len(cfg)
    TL = long_history_len(cfg)
    B = (2 * cfg.p.ncc_patch_radius + 1) ** 2
    D = cfg.p.dyn_max_points
    f32, i32 = torch.float32, torch.int32
    kw = dict(device=resolve_device(device))

    def z(shape, dt=f32):
        return torch.zeros(shape, dtype=dt, **kw)

    def full(shape, v, dt=i32):
        return torch.full(shape, v, dtype=dt, **kw)

    def eye(lead):
        return torch.eye(3, dtype=f32, **kw).expand(*lead, 3, 3).clone()

    tracks = TrackTable(
        pos=z((C, N, 2)), raw=z((C, N, 2)),
        valid=z((C, N), torch.bool), age=z((C, N), i32),
        gain=torch.ones((C, N), dtype=f32, **kw),
        mpt=full((C, N), -1),
        dyn_votes=z((C, N), i32),
        hist=z((C, T, N, 2)), hist_valid=z((C, T, N), torch.bool),
        hist_long=z((C, TL, N, 2)),
        hist_long_valid=z((C, TL, N), torch.bool))
    mappts = MapPoints(
        xyz=z((P, 3)), cov=z((P, 3, 3)), gen=z((P,), i32),
        status=z((P,), i32), ptype=z((P,), i32),
        first_frame=z((P,), i32), last_obs=z((P,), i32),
        bad_votes=z((P,), i32), moved_votes=z((P,), i32),
        owner=z((P,), i32), ncc=z((P, C, B)),
        ncc_valid=z((P, C), torch.bool))
    kfs = KeyframeStore(
        frame=full((KF,), -1), R=eye((KF, C)), t=z((KF, C, 3)),
        obs_pos=z((KF, C, N, 2)), obs_mpt=full((KF, C, N), -1),
        obs_gen=z((KF, C, N), i32), dyn_xyz=z((KF, D, 3)),
        dyn_obs_px=z((KF, C, D, 2)), dyn_obs_ok=z((KF, C, D), torch.bool),
        n=z((), i32))
    return SlamState(
        frame=z((), i32), R=eye((C,)), t=z((C, 3)),
        tracks=tracks, mappts=mappts, kfs=kfs,
        pose_hist_R=eye((C, T)), pose_hist_t=z((C, T, 3)),
        pose_hist_long_R=eye((C, TL)), pose_hist_long_t=z((C, TL, 3)),
        group_id=z((C,), i32))


_TYPES = {c.__name__: c for c in (TrackTable, MapPoints, KeyframeStore,
                                   SlamState)}


def _map_tree(fn, tree):
    """Apply ``fn`` to every leaf. A NamedTuple named like one of this
    module's (the JAX package's own classes included) comes back as this
    module's class."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _TYPES.get(type(tree).__name__, type(tree))
        return cls(*[_map_tree(fn, leaf) for leaf in tree])
    if isinstance(tree, tuple):
        return tuple(_map_tree(fn, leaf) for leaf in tree)
    return fn(tree)


def state_from_numpy(tree, device=None, mesh=None):
    """A state (or any of its NamedTuples) whose leaves are numpy arrays —
    e.g. ``jax.tree.map(np.asarray, jax_state)`` — as the port's tensors,
    same field names, dtypes and shapes. With ``mesh`` (a
    ``parallel.mesh.CamMesh``) the state is placed as a mesh engine keeps
    it: on the mesh's first device."""
    dev = mesh.main if mesh is not None else resolve_device(device)
    return _map_tree(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def state_to_numpy(tree):
    """Inverse of ``state_from_numpy``: every leaf as a numpy array."""
    return _map_tree(lambda a: a.detach().cpu().numpy(), tree)
