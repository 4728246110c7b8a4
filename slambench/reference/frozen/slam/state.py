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

from slambench.reference.frozen.util import resolve_device

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
