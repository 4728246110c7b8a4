"""Checkpoint / resume of a running engine (the port of
``coslam_tpu/io/checkpoint.py``, format v4: the same npz keys, dtypes and
meta JSON, so a checkpoint written by either package loads into the
other's engine).

The reference has no mid-run checkpointing (SURVEY.md §5: end-of-run
export only); this is a capability of the JAX package that the port
keeps. The whole device state (NamedTuples of fixed-shape tensors), the
tracker's reference pyramid and the host-side logs round-trip through one
compressed npz. The pyramid is stored stacked over the cameras, also from
a mesh engine (gathered from its shards), so a file loads into a mesh or
a single-device engine of either package.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from coslam_torch.ops.pyramid import Pyramid
from coslam_torch.slam.fused import ShardedPyramid
from coslam_torch.slam.state import (KeyframeStore, MapPoints, SlamState,
                                     TrackTable, init_state)
from coslam_torch.util import to_host

_FORMAT_VERSION = 4   # v4: pyramid derivatives stored for level 0 only
# v3: long-horizon history/pose rings (60-frame classify window)
_SUB = {"tracks": TrackTable, "mappts": MapPoints, "kfs": KeyframeStore}


def _flatten_state(state: SlamState) -> dict:
    """{"state.<field>[.<field>]": numpy array}, pulled after one wait."""
    keys, leaves = [], []

    def add(prefix, nt):
        for name, val in nt._asdict().items():
            if hasattr(val, "_asdict"):
                add(f"{prefix}{name}.", val)
            else:
                keys.append(f"{prefix}{name}")
                leaves.append(val)

    add("state.", state)
    return dict(zip(keys, to_host(*leaves)))


def _unflatten_state(d: dict, device) -> SlamState:
    def build(cls, prefix):
        kw = {}
        for name in cls._fields:
            key = f"{prefix}{name}"
            if key in d:
                kw[name] = torch.from_numpy(np.array(d[key])).to(device)
            else:
                kw[name] = build(_SUB[name], f"{key}.")
        return cls(**kw)

    return build(SlamState, "state.")


def _json_value(v):
    """numpy scalars in the host logs as plain JSON numbers."""
    if isinstance(v, np.generic):
        return v.item()
    raise TypeError(f"{type(v).__name__} is not JSON serializable")


def save_checkpoint(path: str, engine):
    """Write the engine's full state (device + host logs) to ``path``."""
    # drain the buffered chunk frames and the overlap-deferred stats first
    # (else the last frame's pose is missing from traj while meta['frame']
    # counts it), and apply a BA in flight (its write-back waits on the
    # solve's event) so the checkpoint is BA-consistent
    engine._flush_chunk()
    engine._flush_overlap()
    if engine._pending_ba is not None:
        engine._apply_pending_ba()
    arrays = _flatten_state(engine.state)
    meta = {
        "version": _FORMAT_VERSION,
        "frame": engine.frame,
        "bootstrapped": engine.bootstrapped,
        "kf_frames": engine.kf_frames,
        "group_id": engine.group_id.tolist(),
        "last_merge": engine._last_merge,
        "merge_log": engine.merge_log,
        "group_hist": [list(g) for g in engine.group_hist],
        "split_pending": list(engine._split_pending)
        if engine._split_pending is not None else None,
    }
    arrays["meta"] = np.frombuffer(
        json.dumps(meta, default=_json_value).encode(), dtype=np.uint8)
    arrays["kf_inliers"] = np.asarray(engine._kf_inliers)
    # the tracker's reference pyramid: storing it makes the resume exact
    # and self-contained
    pyr = engine.pyr_prev
    if pyr is not None:
        if isinstance(pyr, ShardedPyramid):     # a mesh engine's shards
            pyr = pyr.gather_levels()
        imgs = to_host(*pyr.imgs, pyr.dxs[0], pyr.dys[0])
        for li in range(len(pyr.imgs)):
            arrays[f"pyr.imgs.{li}"] = imgs[li]
        arrays["pyr.dxs.0"], arrays["pyr.dys.0"] = imgs[-2], imgs[-1]
    for c in range(engine.cfg.num_cameras):
        if engine.traj[c]:
            arrays[f"traj_R.{c}"] = np.stack([p[0] for p in engine.traj[c]])
            arrays[f"traj_t.{c}"] = np.stack([p[1] for p in engine.traj[c]])
        if engine.rel[c]:
            arrays[f"rel_R.{c}"] = np.stack([r[0] for r in engine.rel[c]])
            arrays[f"rel_t.{c}"] = np.stack([r[1] for r in engine.rel[c]])
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, engine):
    """Restore a checkpoint into an engine built with the same config, on
    the engine's device. The engine continues where the saver left off:
    feed it the next frame. (A checkpoint without the reference pyramid
    needs ``engine.resume_reference_frame`` with the last frame.)"""
    d = dict(np.load(path, allow_pickle=False))
    meta = json.loads(bytes(d.pop("meta")).decode())
    if meta["version"] == 2:
        # v2 predates the long-horizon history/pose rings: they start
        # empty, as a fresh state's
        fresh = _flatten_state(init_state(engine.cfg, "cpu"))
        for k in ("state.tracks.hist_long", "state.tracks.hist_long_valid",
                  "state.pose_hist_long_R", "state.pose_hist_long_t"):
            if k not in d:
                d[k] = fresh[k]
    elif meta["version"] == 3:
        pass   # v3 stored derivatives for every level: level 0 is read
    elif meta["version"] != _FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format v{meta['version']} != supported "
            f"v{_FORMAT_VERSION} (v1 checkpoints predate the KeyframeStore "
            "dynamic-snapshot fields; re-create the checkpoint with this "
            "version)")
    dev = engine.device
    engine.state = _unflatten_state(d, dev)
    engine.frame = int(meta["frame"])
    engine.bootstrapped = bool(meta["bootstrapped"])
    engine.kf_frames = list(meta["kf_frames"])
    engine.group_id = np.array(meta["group_id"], np.int32)
    engine._last_merge = int(meta["last_merge"])
    engine.merge_log = list(meta["merge_log"])
    engine.group_hist = [tuple(g) for g in meta.get("group_hist", [])]
    sp = meta.get("split_pending")
    engine._split_pending = tuple(sp) if sp is not None else None
    engine._pose_host_cache = None
    engine._kf_pose_host = None
    engine._kf_inliers = d.pop("kf_inliers")
    n_lvl = sum(k.startswith("pyr.imgs.") for k in d)
    engine.pyr_prev = None
    if n_lvl:
        def T(key):
            return torch.from_numpy(d.pop(key))
        # derivatives at level 0 only (v3 stored every level; the extras
        # are dropped, as build_pyramid makes level 0's only); the pyramid
        # is of the state's frame
        engine.adopt_pyramid(Pyramid(
            imgs=tuple(T(f"pyr.imgs.{li}") for li in range(n_lvl)),
            dxs=(T("pyr.dxs.0"),), dys=(T("pyr.dys.0"),)),
            int(d["state.frame"]))
    C = engine.cfg.num_cameras
    engine.traj = [[] for _ in range(C)]
    engine.rel = [[] for _ in range(C)]
    for c in range(C):
        if f"traj_R.{c}" in d:
            Rs, ts = d[f"traj_R.{c}"], d[f"traj_t.{c}"]
            engine.traj[c] = [(Rs[i], ts[i]) for i in range(Rs.shape[0])]
        if f"rel_R.{c}" in d:
            Rs, ts = d[f"rel_R.{c}"], d[f"rel_t.{c}"]
            engine.rel[c] = [(Rs[i], ts[i]) for i in range(Rs.shape[0])]
    return engine
