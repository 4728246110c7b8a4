"""Host-side engine (the port of ``coslam_tpu/slam/pipeline.py``: one
camera or several).

The per-frame hot path is ``fused.frame_step`` over statically shaped
state on the device, enqueued with no host wait; the host reads one
packed statistics vector per tracked frame and makes the cadence
decisions: the joint multi-camera pose when a camera's static support
collapses, the dynamic-point log, camera grouping (with split
hysteresis), group merges and loop closures on the grouping tick (with
their settle windows and failed-attempt backoffs), inter-camera mapping
and registration, keyframes, windowed BA, periodic duplicate
unification. Frame 0 seeds corners; several cameras bootstrap from the
wide-baseline map init at frame 0 (retried every frame until it
succeeds), one camera from the two-frame E-matrix once ``init_frames``
frames are tracked. Trajectories are chain-corrected to the final
keyframe poses at export.

The engine modes of the reference:
- ``chunk > 1``: ``chunk`` tracked frames go through
  ``fused.frame_steps_chunk`` and their stats rows (with the grouping,
  merge and loop prefilter scan) come back in one copy; the cadence runs
  once per chunk, on the last frame's stats. A partial tail runs through
  the single-frame path.
- ``overlap``: the stats copy of frame f (or chunk k) is started without a
  wait (on a card: a ``non_blocking`` copy into one of two pinned buffers
  and a CUDA event) and read one frame (chunk) later, so the cadence acts
  on one-frame-old stats and the host never waits a round trip.
- ``async_ba``: the windowed BA is dispatched and applied a few frames
  later (on a card its solve runs on a side CUDA stream; ``_poll_ba``
  applies it once the solve's event has completed, or after ``max_defer``
  frames), with the slot-generation guard of
  ``steps.apply_ba_table_results``; a committed merge or loop closure
  cancels a solve in flight (the reference's BA thread and bCancelBA).
  Merge and loop polish BAs stay synchronous.
- ``use_fused=False``: the step's stages as separate calls, the cadence,
  then the lifecycle update.
- ``profile``: ``timing`` accumulates wall seconds per stage (``_tick``),
  synchronizing the card first.
- ``log_features``: ``feat_log`` gets (frame, camera, map ids, pixels) of
  every mapped feature after each frame past the bootstrap (the
  reference's per-frame feature export), pulled after the cadence (one
  wait).

Not ported yet (raises NotImplementedError naming its ROADMAP.md item):
multi-device meshes and BA on another card (A18).
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from coslam_torch.config import SlamConfig
from coslam_torch.geometry import camera as cam
from coslam_torch.geometry import epipolar
from coslam_torch.geometry.triangulate import triangulation_cov
from coslam_torch.ops.corners import detect_corners
from coslam_torch.ops.pyramid import build_pyramid
from coslam_torch.slam import steps
from coslam_torch.slam.classify import (classify_map_points,
                                        detect_dynamic_features)
from coslam_torch.slam.fused import (frame_step, frame_steps_chunk,
                                     pack_stats, unpack_stats)
from coslam_torch.slam.grouping import (camera_grouping,
                                        group_camera_tuples, host_scan_device)
from coslam_torch.slam.initmap import init_map_multicam
from coslam_torch.slam.intercam import (intercam_map_group,
                                        joint_pose_update,
                                        register_map_points)
from coslam_torch.slam.loop import close_loop, find_loop_candidates
from coslam_torch.slam.merge import (MergeCandidate, fuse_close_points,
                                     fuse_duplicate_points, merge_candidates,
                                     merge_groups)
from coslam_torch.slam.state import (PT_DYNAMIC, PT_STATIC, ST_ALIVE,
                                     SlamState, init_state)
from coslam_torch.solvers.ba import bundle_adjust_table
from coslam_torch.solvers.pose_graph import (chain_graph,
                                             solve_chain_segments,
                                             solve_rotations,
                                             solve_translations)
from coslam_torch.util import (nanmedian, resolve_device, set_drop,
                               to_device, to_host)

# cadence (frames) of the grouping tick, on which the merge and loop
# checks run
GROUPING_INTERVAL = 5
# frames after a merge or loop closure: no re-grouping and no closure
# attempt, and widened pose gates (the reference's largeErr frames)
SETTLE_FRAMES = 12


def _pack_rt(R, t):
    """[..., 3, 3] + [..., 3] -> [..., 3, 4] (one transfer for a pose)."""
    return torch.cat([R, t[..., None]], dim=-1)


def _same_device(a: torch.device, b: torch.device) -> bool:
    def index(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index
    return a.type == b.type and index(a) == index(b)


class HostCopies:
    """Device-to-host copies of packed stats that the host reads later
    (overlap mode). On a card a vector is copied with ``non_blocking=True``
    into one of two pinned buffers of its size, taken in turns, and a CUDA
    event is recorded behind the copy; ``read`` waits on that event only.
    The engine reads each copy before it starts the second one after it,
    so a copy in flight never lands in a buffer still to be read. On the
    CPU the copy is a clone."""

    def __init__(self):
        self._bufs: dict = {}
        self._turn: dict = {}

    def start(self, v: torch.Tensor):
        """Start copying ``v``; returns the pending copy for ``read``."""
        if not v.is_cuda:
            return v.clone(), None
        n = v.numel()
        i = self._turn.get(n, 0)
        self._turn[n] = 1 - i
        buf = self._bufs.get((n, i))
        if buf is None:
            buf = self._bufs[(n, i)] = torch.empty(n, dtype=v.dtype,
                                                   pin_memory=True)
        buf.copy_(v.reshape(-1), non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return buf, done

    @staticmethod
    def read(pending) -> np.ndarray:
        """The copied vector as a numpy array of its own, once it landed."""
        buf, done = pending
        if done is not None:
            done.synchronize()
        return buf.numpy().copy()


class CoSlamEngine:
    """One engine = C synchronized cameras (the CoSLAM object equivalent).

    Usage:
        eng = CoSlamEngine(cfg, K, kc)            # on the CUDA device
        for f in range(F):
            stats = eng.process_frame(images[f])  # [C, H, W]
        Rs, ts = eng.trajectory(c)                # corrected, camera c

    ``device`` defaults to CUDA and raises when no card is present; pass
    ``device="cpu"`` to run the plain PyTorch path on the CPU. The modes
    (``chunk``, ``overlap``, ``async_ba``, ``use_fused``, ``profile``) are
    the reference's; see the module docstring. ``ba_device`` may only name
    the engine's own device (another card is ROADMAP A18)."""

    def __init__(self, cfg: SlamConfig, K, kc, device=None,
                 profile: bool = False, use_fused: bool = True,
                 async_ba: bool = False, ba_device=None,
                 overlap: bool = False, chunk: int = 1, mesh=None,
                 log_features: bool = False):
        if mesh is not None:
            raise NotImplementedError(
                "multi-device meshes are not ported yet: ROADMAP.md item A18")
        self.cfg = cfg
        self.device = resolve_device(device)
        if ba_device is not None and \
                not _same_device(torch.device(ba_device), self.device):
            raise NotImplementedError(
                "BA on another device than the engine's is not ported yet: "
                "ROADMAP.md item A18")
        self.profile = profile
        self.use_fused = use_fused
        self.async_ba = async_ba
        self.ba_device = ba_device
        self.overlap = overlap
        self.chunk = max(1, int(chunk))
        self.log_features = log_features
        self.feat_log: list[tuple] = []    # (frame, cam, ids, xy)
        self.timing: dict[str, float] = {}
        C = cfg.num_cameras
        K = torch.as_tensor(np.asarray(K, np.float32))
        if tuple(K.shape) != (C, 3, 3):
            raise ValueError(f"K must be [{C}, 3, 3], got {tuple(K.shape)}")
        self.K = K.to(self.device)
        self.kc = torch.as_tensor(np.asarray(kc, np.float32)).to(self.device)
        self.distorted = bool(np.any(np.asarray(kc, np.float32) != 0))
        self.state = init_state(cfg, self.device)
        self.pyr_prev = None
        self.frame = 0
        self.bootstrapped = False
        # host logs
        self.traj: list[list] = [[] for _ in range(C)]   # (R, t) per frame
        self.rel: list[list] = [[] for _ in range(C)]    # frame-to-frame rels
        self.kf_frames: list[int] = []
        self._kf_inliers = np.zeros(C)
        self.stats_log: list[dict] = []
        self.ba_runs = 0
        self.group_id = np.zeros(C, np.int32)
        self.group_hist: list[tuple] = []   # per-frame group ids
        self.dyn_log: list[tuple] = []      # (frame, ids, xyz) dynamic points
        self._split_pending = None          # grouping-split hysteresis
        self._scan_frame = -1               # frame of the cached host scan
        self._scan_cache = None
        self._last_grouping = -10 ** 9
        self._last_intercam = -10 ** 9
        self._last_register = -10 ** 9
        self._last_fuse = 0
        self.merge_log: list[dict] = []     # committed merges (and no-ops)
        self.loop_log: list[dict] = []      # committed loop closures
        self._last_merge = 0
        self._last_merge_try = -10 ** 9
        self._merge_backoff = 0             # grows on failed bridges
        self._merge_was_possible = False
        self._last_closure = 0
        self._last_loop_attempt = -10 ** 9
        self._loop_backoff = GROUPING_INTERVAL
        self._large_err_until = 0           # end of the widened-gate window
        self._kf_pose_host = None   # (R, t) of the last keyframe, numpy
        self._pose_host_cache = None
        self._pose_prefetch = None   # packed poses fetched right after BA
        self._kf_prefetch = None
        # overlap: (frame, pending copy) of the stats read next frame
        self._copies = HostCopies()
        self._pending_fs = None
        self._flushing = False       # inside _flush_overlap
        # chunk mode: buffered frames, and (overlap) the chunk whose stats
        # are read after the next chunk is enqueued: (f0, n, pending copy)
        self._chunk_buf: list = []
        self._chunk_pending = None
        # async BA: the solve in flight, its side stream, and what became
        # of each dispatch: applied once its event completed ("ready"),
        # after max_defer frames ("deferred"), before a keyframe, another
        # BA or on request ("flushed"), or dropped by a merge or loop
        # closure ("cancelled")
        self._pending_ba: Optional[dict] = None
        self._ba_stream = None
        self.ba_async = dict(dispatched=0, ready=0, deferred=0, flushed=0,
                             cancelled=0)

    # ------------------------------------------------------------------
    @property
    def img_hw(self):
        return (self.cfg.image_height, self.cfg.image_width)

    def _tick(self, name: str, t0: float) -> float:
        """Accumulate the wall time since ``t0`` under ``name`` (the
        reference's per-stage clock). With ``profile=True`` the card is
        synchronized first, so a stage's time is its execution, not its
        enqueueing."""
        if self.profile and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.timing[name] = self.timing.get(name, 0.0) + (t1 - t0)
        return t1

    def resume_reference_frame(self, images):
        """After ``io.checkpoint.load_checkpoint`` of a checkpoint without
        the reference pyramid: rebuild the tracker's reference pyramid from
        the last processed frame's images [C, H, W]."""
        imgs = to_device(images, self.device).to(torch.float32)
        self.pyr_prev = build_pyramid(imgs, self.cfg.klt.n_levels)

    def process_frame(self, images) -> dict:
        """Feed one frame: images [C, H, W] (numpy or tensor, float32 or
        uint8, 0..255). Returns the frame's statistics: in chunk mode a
        buffered frame returns {"frame", "buffered": True} and the chunk's
        last frame the cadence's statistics; in overlap mode the statistics
        are those of the previous tracked frame."""
        cfg = self.cfg
        if self.chunk > 1 and self.bootstrapped and self.use_fused \
                and self.frame > 0:
            self._chunk_buf.append(images)
            if len(self._chunk_buf) < self.chunk:
                return {"frame": self.frame + len(self._chunk_buf) - 1,
                        "buffered": True}
            return self._process_chunk()
        t0 = time.perf_counter()
        self._pose_host_cache = None   # state.R/t will change this frame
        self._pose_prefetch = None
        self._kf_prefetch = None
        imgs = to_device(images, self.device).to(torch.float32)
        t0 = self._tick("upload", t0)
        if self.bootstrapped and self.use_fused and self.frame > 0:
            self.state, pyr, fs = frame_step(
                self.state, self.pyr_prev, imgs, self.K, self.kc, cfg,
                large_err=self.frame < self._large_err_until)
            fsv = pack_stats(fs)
            t0 = self._tick("core_fused", t0)
            stats = {"frame": self.frame}
            log_entry = True
            if self.overlap:
                # this frame's stats start copying now and are read next
                # frame: the cadence acts on one-frame-old stats
                pending = self._copies.start(fsv)
                t0 = self._tick("copy_async", t0)
                prev = self._pending_fs
                self._pending_fs = (self.frame, pending)
                if prev is not None:
                    pframe, pv = prev
                    stats["frame"] = pframe
                    stats.update(self._host_cadence(pyr, pv, frame=pframe))
                    t0 = self._tick("cadence_total", t0)
                    self._record_pose()
                    t0 = self._tick("record_pose", t0)
                else:
                    # transition frame: its stats are read (and logged)
                    # next frame
                    log_entry = False
            else:
                stats.update(self._host_cadence(pyr, fsv))
                self._record_pose()
            if self.log_features:
                self._log_features()
            self.pyr_prev = pyr
            self.group_hist.append(tuple(self.group_id.tolist()))
            self.frame += 1
            stats.setdefault("n_inliers", np.zeros(cfg.num_cameras))
            if log_entry:
                self.stats_log.append(stats)
            return stats
        pyr = build_pyramid(imgs, cfg.klt.n_levels)
        t0 = self._tick("pyramid", t0)
        stats = {"frame": self.frame}
        if self.frame == 0:
            self._first_frame(pyr)
            if cfg.num_cameras > 1:
                stats["bootstrap"] = self._bootstrap_multicam(pyr)
        else:
            t1 = time.perf_counter()
            self.state = self.state._replace(
                tracks=steps.advance_tracks(
                    self.pyr_prev, pyr, self.state.tracks, self.K, self.kc,
                    self.state.frame + 1, cfg),
                frame=self.state.frame + 1)
            self._tick("tracking", t1)
            if not self.bootstrapped:
                t1 = time.perf_counter()
                if cfg.num_cameras > 1:
                    stats["bootstrap"] = self._bootstrap_multicam(pyr)
                elif self.frame >= cfg.p.init_frames:
                    stats["bootstrap"] = self._bootstrap(pyr)
                self._tick("bootstrap", t1)
            else:
                stats.update(self._tracked_frame(pyr))
        self._record_pose()
        if self.log_features and self.bootstrapped:
            self._log_features()
        self.pyr_prev = pyr
        self.group_hist.append(tuple(self.group_id.tolist()))
        self.frame += 1
        stats.setdefault("n_inliers", np.zeros(cfg.num_cameras))
        self.stats_log.append(stats)
        return stats

    # ------------------------------------------------------------------
    def _process_chunk(self) -> dict:
        """The buffered frames through ONE ``frame_steps_chunk`` call, then
        the cadence once at the boundary. Per-frame poses and dynamic
        snapshots come from the packed stats rows: the chunk is enqueued
        with no host wait until its one stats copy."""
        t0 = time.perf_counter()
        buf, self._chunk_buf = self._chunk_buf, []
        n = len(buf)
        self._pose_host_cache = None
        self._pose_prefetch = None
        self._kf_prefetch = None
        imgs = torch.stack([to_device(f, self.device) for f in buf]).to(
            torch.float32)
        t0 = self._tick("upload", t0)
        self.state, pyr, flat = frame_steps_chunk(
            self.state, self.pyr_prev, imgs, self.K, self.kc, self.cfg,
            large_err=self.frame < self._large_err_until)
        self.pyr_prev = pyr
        t0 = self._tick("core_chunk", t0)
        if self.overlap:
            # this chunk's stats start copying; the previous chunk's, whose
            # copy rode behind this chunk's work, are read now
            pending = self._chunk_pending
            self._chunk_pending = (self.frame, n, self._copies.start(flat))
            self.frame += n
            t0 = self._tick("copy_async", t0)
            if pending is None:
                return {"frame": self.frame - 1, "buffered": True}
            out = self._consume_chunk_stats(*pending)
            self._tick("cadence_total", t0)
            return out
        flat = flat.cpu().numpy()                   # the one round trip
        t0 = self._tick("stats_wait", t0)
        return self._ingest_chunk_rows(self.frame, n, flat, t0=t0)

    def _consume_chunk_stats(self, f0: int, n: int, pending) -> dict:
        """Overlap mode: logs and cadence of a chunk the device has already
        moved past. The bookkeeping runs with the chunk's frame numbers; the
        cadence's actions apply to the current, newer state."""
        saved = self.frame
        self.frame = f0
        try:
            return self._ingest_chunk_rows(f0, n, HostCopies.read(pending))
        finally:
            self.frame = saved

    def _ingest_chunk_rows(self, f0: int, n: int, flat: np.ndarray,
                           t0: Optional[float] = None) -> dict:
        """Unpack a chunk's flat stats: per-frame poses, logs and dynamic
        snapshots, then the cadence on the last frame's stats, with the
        chunk's scan block as the host-scan cache."""
        C = self.cfg.num_cameras
        pyr = self.pyr_prev
        if t0 is None:
            t0 = time.perf_counter()
        scan_len = C * (3 * C + 2)
        rows = flat[:len(flat) - scan_len].reshape(n, -1)
        scan = flat[len(flat) - scan_len:].reshape(C, 3 * C + 2)
        D = self.state.kfs.dyn_xyz.shape[1]
        fs_last = None
        for i in range(n):
            fs = unpack_stats(rows[i], C, D)
            fs_last = fs
            self._pose_host_cache = (fs.R.copy(), fs.t.copy())
            self._record_pose()
            # the last row's snapshot is logged by the cadence below
            if C > 1 and i < n - 1 and int(fs.n_dynamic) > 0:
                sel = fs.dyn_ids >= 0
                if sel.any():
                    self.dyn_log.append((f0 + i, fs.dyn_ids[sel],
                                         fs.dyn_xyz[sel]))
            entry = {"frame": f0 + i, "n_inliers": fs.n_inliers,
                     "coverage": fs.coverage, "med_err": fs.med_err,
                     "med_depth": fs.med_depth,
                     "n_new_points": int(fs.n_new_points)}
            if C > 1:
                entry["n_static"] = int(fs.n_static)
                entry["n_dynamic"] = int(fs.n_dynamic)
            self.stats_log.append(entry)
            self.group_hist.append(tuple(self.group_id.tolist()))
        self.frame = f0 + n - 1
        self._poll_ba()
        self._scan_cache = (scan[:, :C], scan[:, C:2 * C],
                            scan[:, 2 * C:3 * C], scan[:, 3 * C],
                            scan[:, 3 * C + 1])
        self._scan_frame = self.frame
        cstats = self._shared_cadence(
            pyr, fs_last, n_mapped=fs_last.n_mapped,
            n_new=int(fs_last.n_new_points),
            dyn=(fs_last.dyn_ids, fs_last.dyn_xyz),
            n_static=int(fs_last.n_static),
            n_dynamic=int(fs_last.n_dynamic), frame=self.frame)
        self.stats_log[-1].update(cstats)
        if self.log_features:
            self._log_features()
        self.frame = f0 + n
        self._tick("cadence_total", t0)
        return self.stats_log[-1]

    def _flush_chunk(self):
        """Read the overlap-pending chunk's stats, then run any buffered
        frames of a partial chunk through the single-frame path."""
        if self._chunk_pending is not None:
            pending, self._chunk_pending = self._chunk_pending, None
            self._consume_chunk_stats(*pending)
        if not self._chunk_buf:
            return
        buf, self._chunk_buf = self._chunk_buf, []
        saved = self.chunk
        self.chunk = 1
        try:
            for f in buf:
                self.process_frame(f)
        finally:
            self.chunk = saved

    def _flush_overlap(self):
        """Read the pending overlapped stats: the last frame's cadence and
        its pose, so the trajectory covers every processed frame."""
        if not self.overlap or self._pending_fs is None:
            return
        pframe, pv = self._pending_fs
        self._pending_fs = None
        stats = {"frame": pframe}
        self._flushing = True
        try:
            stats.update(self._host_cadence(self.pyr_prev, pv, frame=pframe))
        finally:
            self._flushing = False
        self._record_pose()
        self.stats_log.append(stats)

    # ------------------------------------------------------------------
    def _first_frame(self, pyr):
        cfg = self.cfg
        N = cfg.cap.max_features
        det = detect_corners(pyr.imgs[0], pyr.dxs[0], pyr.dys[0], cfg.klt, N)
        # seed_tracks expects undistorted px; detector output is raw px
        pos_ud = cam.undistort_points(det.pos, self.K[:, None],
                                      self.kc[:, None])
        tracks = steps.seed_tracks(
            self.state.tracks, pos_ud, det.valid,
            torch.full(det.valid.shape, -1, dtype=torch.int32,
                       device=self.device), self.K, self.kc, 0)
        self.state = self.state._replace(tracks=tracks)

    def _bootstrap_multicam(self, pyr) -> bool:
        """Wide-baseline bootstrap between the cameras (initMapMultiCam):
        frame 0, retried on every frame until it succeeds. Under lens
        distortion the init reads the corners on the distorted image
        (``raw``) where the JAX package's reads them undistorted and
        undistorts them twice (ROADMAP.md, C3); without distortion it is
        the JAX package's call."""
        st = self.state
        res = init_map_multicam(self.cfg, self.K, self.kc, pyr,
                                st.tracks.pos, st.tracks.valid,
                                raw=st.tracks.raw if self.distorted else None)
        if not res.ok:
            return False
        C, N = st.tracks.valid.shape
        M = res.X.shape[0]
        dev = self.device
        mp = st.mappts
        mp = mp._replace(
            xyz=torch.cat([torch.as_tensor(res.X, device=dev), mp.xyz[M:]]),
            cov=torch.cat([torch.as_tensor(res.cov, device=dev),
                           mp.cov[M:]]),
            status=torch.cat([torch.full_like(mp.status[:M], ST_ALIVE),
                              mp.status[M:]]),
            ptype=torch.cat([torch.full_like(mp.ptype[:M], PT_STATIC),
                             mp.ptype[M:]]),
            first_frame=torch.cat([st.frame.expand(M).to(mp.first_frame),
                                   mp.first_frame[M:]]),
            last_obs=torch.cat([st.frame.expand(M).to(mp.last_obs),
                                mp.last_obs[M:]]))
        mpt = np.full((C, N), -1, np.int32)
        for c in range(C):
            has = res.obs_slot[:, c] >= 0
            mpt[c, res.obs_slot[has, c]] = np.nonzero(has)[0]
        # reset the track history: after retries, the pre-bootstrap ring
        # entries pair with unset pose-ring slots
        tracks = steps.seed_tracks(st.tracks, st.tracks.pos, st.tracks.valid,
                                   torch.as_tensor(mpt, device=dev), self.K,
                                   self.kc, st.frame)
        state = st._replace(tracks=tracks, mappts=mp,
                            R=torch.as_tensor(res.Rs, device=dev),
                            t=torch.as_tensor(res.ts, device=dev))
        state = steps.push_pose_history(state)
        self.state = state._replace(kfs=steps.add_keyframe(state))
        self.bootstrapped = True
        self.kf_frames = [self.frame]
        self._kf_inliers = np.full(C, float(M))
        return True

    def _bootstrap(self, pyr) -> bool:
        """Monocular two-frame bootstrap (initMapSingleCam): E-matrix
        between frame 0 and now, triangulate, anchor the scale at
        ``bootstrap_depth`` median depth. The RANSAC samples come from a
        generator seeded with the frame number."""
        cfg = self.cfg
        st = self.state
        x0 = st.tracks.hist[:, 0]              # frame-0 ring slot, undist px
        ok0 = st.tracks.hist_valid[:, 0] & st.tracks.valid
        c = 0
        xn0 = cam.pixel_to_normalized(x0[c], self.K[c])
        xn1 = cam.pixel_to_normalized(st.tracks.pos[c], self.K[c])
        thresh = (1.5 / float(self.K[c, 0, 0])) ** 2
        gen = torch.Generator().manual_seed(self.frame)
        res = epipolar.ransac_essential(gen, xn0, xn1, ok0[c],
                                        num_hypotheses=512, thresh=thresh)
        if int(res.num_inliers) < 30:
            return False
        R1, t1, X, good = epipolar.recover_pose_from_essential(
            res.F, xn0, xn1, res.inliers)
        if int(torch.sum(good)) < 30:
            return False
        med_z = float(nanmedian(torch.where(
            good, X[:, 2], torch.full_like(X[:, 2], math.nan)), 0))
        if not np.isfinite(med_z) or med_z <= 0:
            return False
        s = cfg.p.bootstrap_depth / med_z
        X = X * s
        t1 = t1 * s
        # first-order covariance of the bootstrap triangulation
        n = X.shape[0]
        f32 = torch.float32
        Ks2 = self.K[c][None, None].expand(n, 2, 3, 3)
        eye = torch.eye(3, dtype=f32, device=self.device)[None].expand(n, 3, 3)
        Rs2 = torch.stack([eye, R1[None].expand(n, 3, 3)], dim=1)
        ts2 = torch.stack([torch.zeros((n, 3), dtype=f32, device=self.device),
                           t1[None].expand(n, 3)], dim=1)
        covX = triangulation_cov(Ks2, Rs2, ts2, X,
                                 torch.ones((n, 2), dtype=torch.bool,
                                            device=self.device),
                                 pixel_var=cfg.p.pixel_err_var)
        self.state = self._bootstrap_commit(st, R1, t1, X, good, x0, covX)
        self.bootstrapped = True
        self.kf_frames = [0, self.frame]
        return True

    def _bootstrap_commit(self, st: SlamState, R1, t1, X, good, x0, covX):
        """Write bootstrap results into the state. Camera 0 only."""
        C, N = st.tracks.valid.shape
        P = st.mappts.xyz.shape[0]
        # the first sum(good) map slots go to the good tracks of camera 0
        rank = torch.cumsum(good.to(torch.int64), 0) - 1
        slot = torch.where(good, rank, P)
        mpt_c0 = torch.where(good, slot, -1).to(torch.int32)
        mp = st.mappts
        mp = mp._replace(
            xyz=set_drop(mp.xyz, slot, X),
            cov=set_drop(mp.cov, slot, covX),
            status=set_drop(mp.status, slot, ST_ALIVE),
            ptype=set_drop(mp.ptype, slot, PT_STATIC),
            first_frame=set_drop(mp.first_frame, slot, 0),
            last_obs=set_drop(mp.last_obs, slot, st.frame))
        mpt = torch.full((C, N), -1, dtype=torch.int32, device=self.device)
        mpt[0] = mpt_c0
        tracks = steps.seed_tracks(st.tracks, st.tracks.pos, st.tracks.valid,
                                   mpt, self.K, self.kc, st.frame)
        R = st.R.clone()
        t = st.t.clone()
        R[0] = R1
        t[0] = t1
        state = st._replace(tracks=tracks, mappts=mp, R=R, t=t)
        state = steps.push_pose_history(state)
        # keyframe 0 (identity pose, frame-0 observations) + this keyframe
        kfs = state.kfs
        frame0, obs_pos, obs_mpt = (kfs.frame.clone(), kfs.obs_pos.clone(),
                                    kfs.obs_mpt.clone())
        frame0[0] = 0
        obs_pos[0, 0] = x0[0]
        obs_mpt[0, 0] = mpt_c0
        state = state._replace(kfs=kfs._replace(
            frame=frame0, obs_pos=obs_pos, obs_mpt=obs_mpt, n=kfs.n + 1))
        state = state._replace(kfs=steps.add_keyframe(state))
        self._kf_inliers = np.full(C, float(torch.sum(good)))
        return state

    # ------------------------------------------------------------------
    def _host_cadence(self, pyr, fsv, frame: Optional[int] = None) -> dict:
        """Tracked-frame cadence: ONE device-to-host copy (the packed stats,
        post-step poses included), then the shared cadence. ``fsv`` is the
        packed stats tensor, or (overlap mode) a copy started a frame
        earlier; ``frame`` stamps the log entries (one frame back in overlap
        mode)."""
        t0 = time.perf_counter()
        self._poll_ba()
        t0 = self._tick("poll_ba", t0)
        v = HostCopies.read(fsv) if isinstance(fsv, tuple) else \
            fsv.cpu().numpy()
        fs = unpack_stats(v, self.cfg.num_cameras,
                          self.state.kfs.dyn_xyz.shape[1])
        self._tick("stats_wait", t0)
        self._pose_host_cache = (fs.R.copy(), fs.t.copy())
        # the dynamic snapshot rides the stats copy
        return self._shared_cadence(
            pyr, fs, n_mapped=fs.n_mapped, n_new=int(fs.n_new_points),
            dyn=(fs.dyn_ids, fs.dyn_xyz), n_static=int(fs.n_static),
            n_dynamic=int(fs.n_dynamic),
            frame=self.frame if frame is None else frame)

    def _log_features(self):
        """(frame, camera, ids, xy) of every mapped feature of the current
        state into ``feat_log``."""
        tr = self.state.tracks
        pos, mpt, valid = to_host(tr.pos, tr.mpt, tr.valid)
        ok = valid & (mpt >= 0)
        for c in range(self.cfg.num_cameras):
            sel = np.nonzero(ok[c])[0]
            self.feat_log.append((self.frame, c, mpt[c, sel], pos[c, sel]))

    def _tracked_frame(self, pyr) -> dict:
        """The non-fused path (``use_fused=False``): the fused step's
        stages as separate calls after ``advance_tracks`` (pose update, pose
        history, classification with several cameras, new map points), the
        shared cadence, and the lifecycle update after the cadence (the
        fused step runs it before), as the reference orders them."""
        cfg = self.cfg
        C = cfg.num_cameras
        t0 = time.perf_counter()
        self._poll_ba()
        out = steps.pose_update(self.state, self.K, self.kc, self.img_hw,
                                cfg,
                                large_err=self.frame < self._large_err_until)
        self.state = self.state._replace(
            R=out.R, t=out.t, tracks=out.tracks, mappts=out.mappts)
        self.state = steps.push_pose_history(self.state)
        t0 = self._tick("pose_update", t0)
        n_static = n_dynamic = torch.zeros((), dtype=torch.int32,
                                           device=self.device)
        if C > 1:
            self.state = detect_dynamic_features(self.state, self.K, cfg)
            cls = classify_map_points(self.state, self.K, cfg)
            self.state = self.state._replace(mappts=cls.mappts,
                                             tracks=cls.tracks)
            n_static, n_dynamic = cls.n_static, cls.n_dynamic
        t0 = self._tick("classify", t0)
        mappts, tracks, n_new = steps.new_map_points(
            self.state, pyr, self.K, self.kc, cfg)
        self.state = self.state._replace(mappts=mappts, tracks=tracks)
        self._tick("new_map_points", t0)
        n_mapped = torch.sum(tracks.valid & (tracks.mpt >= 0), dim=1)
        n_inl, cover, med_err, med_depth, n_mapped, n_new, n_static, \
            n_dynamic = to_host(out.n_inliers, out.coverage, out.med_err,
                                out.med_depth, n_mapped, n_new, n_static,
                                n_dynamic)
        host = SimpleNamespace(n_inliers=n_inl, coverage=cover,
                               med_err=med_err, med_depth=med_depth)
        stats = self._shared_cadence(pyr, host, n_mapped=n_mapped,
                                     n_new=int(n_new), dyn=None,
                                     n_static=int(n_static),
                                     n_dynamic=int(n_dynamic),
                                     frame=self.frame)
        self.state = self.state._replace(
            mappts=steps.lifecycle_update(self.state.mappts,
                                          self.state.frame, cfg))
        return stats

    def _shared_cadence(self, pyr, out, n_mapped: np.ndarray, n_new: int,
                        dyn, n_static: int, n_dynamic: int,
                        frame: int) -> dict:
        """Host-decided per-frame work: the joint-pose fallback, the
        dynamic-point log, grouping (and where groups could merge, the
        merge check), the loop-closure check, inter-camera mapping and
        registration, keyframes + BA, duplicate unification. ``dyn`` is the
        (ids, xyz) snapshot of the dynamic points from the stats copy (None:
        pulled from the device when there are dynamic points); ``frame``
        stamps the log entries (one frame behind ``self.frame`` in overlap
        mode)."""
        cfg = self.cfg
        p = cfg.p
        C = cfg.num_cameras
        t0 = time.perf_counter()
        n_inl = np.asarray(out.n_inliers)
        cover = np.asarray(out.coverage)
        joint = False
        grouping_due = self.frame - self._last_grouping >= GROUPING_INTERVAL
        if grouping_due:
            self._last_grouping = self.frame
        if C > 1:
            # a camera whose static support collapsed (a mover filling its
            # view) rides the joint solve through the dynamic points it
            # shares with the others (interCamPoseUpdate); only the group's
            # total static support must hold the frame
            weak = (n_inl < p.min_static_for_ok) | (cover < p.min_static_cover)
            if weak.any() and n_inl.sum() >= p.min_static_for_ok:
                R, t = joint_pose_update(self.state, self.K, cfg)
                self.state = steps.push_pose_history(
                    self.state._replace(R=R, t=t))
                self._pose_host_cache = None
                self._pose_prefetch = None
                joint = True
            if n_dynamic > 0:
                if dyn is not None:
                    ids, xyz = dyn
                    sel = ids >= 0
                    if sel.any():
                        self.dyn_log.append((frame, ids[sel], xyz[sel]))
                else:
                    self._store_dynamic_snapshot(frame)
            # no re-grouping while shared observations re-form after a merge
            if grouping_due and self._settled():
                self._update_grouping()
            t0 = self._tick("cad_grouping", t0)
            # group merge (mergeCamGroups) on the grouping tick, so it
            # never acts on stale group ids
            if (len(np.unique(self.group_id)) > 1 and grouping_due
                    and self.frame - self._last_merge
                    >= p.merge_min_interval):
                self._merge_tick(pyr)
            t0 = self._tick("cad_merge", t0)
        if grouping_due:
            self._try_loop_closure(pyr)
        t0 = self._tick("cad_loop", t0)
        n_inter = self._intercam_cadence(pyr, n_mapped, n_inl)
        t0 = self._tick("cad_intercam", t0)
        stats = {
            "n_inliers": n_inl,
            "coverage": cover,
            "med_err": np.asarray(out.med_err),
            "med_depth": np.asarray(out.med_depth),
            "n_new_points": n_new,
            "n_intercam_points": n_inter,
            "joint_pose": joint,
        }
        if C > 1:
            stats["n_static"] = n_static
            stats["n_dynamic"] = n_dynamic
        kf_ready = self._keyframe_ready(out)
        t0 = self._tick("cad_kfready", t0)
        if kf_ready:
            # a keyframe snapshots BA-consistent poses: an in-flight BA is
            # applied first
            self._apply_pending_ba()
            self.state = self.state._replace(
                kfs=steps.add_keyframe(self.state))
            # the device's frame: while _flush_overlap runs, self.frame is
            # one past the last processed frame
            self.kf_frames.append(self.frame - 1 if self._flushing
                                  else self.frame)
            self._kf_inliers = n_inl.copy()
            self._kf_pose_host = self._pose_host()
            t0 = self._tick("cad_addkf", t0)
            if len(self.kf_frames) % cfg.p.ba_cadence == 0:
                self._run_ba()
                # a solve that already finished is applied this frame
                self._poll_ba()
                t0 = self._tick("ba", t0)
            stats["keyframe"] = True
        # periodic duplicate unification (every 50th frame)
        if self.frame - self._last_fuse >= 50:
            self._last_fuse = self.frame
            self.state, n_fused = fuse_close_points(self.state, cfg)
            if n_fused:
                stats["n_fused"] = n_fused
        return stats

    def _intercam_cadence(self, pyr, n_mapped: np.ndarray,
                          n_inl: np.ndarray) -> int:
        """Multi-view inter-camera mapping and registration. Mapping runs
        when the mapped-feature budget drops under ``n_max_map_pts`` (at
        most every ``intercam_map_interval`` frames) or on an inlier-count
        decrease (its own minimum spacing: half the interval); registration
        keeps its fixed cadence."""
        p = self.cfg.p
        if self.cfg.num_cameras <= 1:
            return 0
        n_inter = 0
        since = self.frame - self._last_intercam
        budget_low = int(n_mapped.sum()) < p.n_max_map_pts
        decrease = bool(np.any(n_inl < 0.8 * np.maximum(self._kf_inliers, 1)))
        decrease = decrease and since >= max(1, p.intercam_map_interval // 2)
        t0 = time.perf_counter()
        if (since >= p.intercam_map_interval and budget_low) or decrease:
            for cams in group_camera_tuples(self.group_id):
                mp, tr, nn = intercam_map_group(self.state, pyr, self.K,
                                                self.kc, cams, self.cfg)
                self.state = self.state._replace(mappts=mp, tracks=tr)
                n_inter += int(nn)
            self._last_intercam = self.frame
        t0 = self._tick("cad_icmap", t0)
        if self.frame - self._last_register >= p.intercam_map_interval:
            self._last_register = self.frame
            self.state, _ = register_map_points(
                self.state, pyr, self.K, self.cfg, max_age=p.num_act_frames)
        self._tick("cad_register", t0)
        return n_inter

    def _host_scan(self):
        """The packed device reduction behind grouping and the merge check,
        one copy per frame at most. Returns (shared [C,C], area [C,C],
        merge_counts [C,C], alive_per_owner [C], dormant_counts [C])."""
        if self._scan_frame != self.frame or self._scan_cache is None:
            C = self.cfg.num_cameras
            arr = host_scan_device(
                self.state, self.K, self.cfg.image_height,
                self.cfg.image_width, self.cfg.p.loop_dormant_age)
            arr = arr.cpu().numpy()
            self._scan_cache = (arr[:, :C], arr[:, C:2 * C],
                                arr[:, 2 * C:3 * C], arr[:, 3 * C],
                                arr[:, 3 * C + 1])
            self._scan_frame = self.frame
        return self._scan_cache

    def _merge_possible(self) -> bool:
        """Superset test of checkPossibleMergable from the device scan."""
        _, _, mc, alive_own, _ = self._host_scan()
        p = self.cfg.p
        for a in range(self.cfg.num_cameras):
            for g in np.unique(self.group_id):
                if g == self.group_id[a]:
                    continue
                cams_g = self.group_id == g
                cnt = float(mc[a, cams_g].sum())
                n_own = float(alive_own[cams_g].sum())
                if cnt >= p.merge_overlap_min or \
                        (n_own > 0 and cnt / n_own >= p.merge_overlap_ratio):
                    return True
        return False

    def _settled(self) -> bool:
        """Past the settle window of the last merge."""
        return not self.merge_log or \
            self.frame - self.merge_log[-1]["frame"] > SETTLE_FRAMES

    def _merge_tick(self, pyr):
        """The merge check of a grouping tick: the device prefilter on every
        tick (the moment overlap re-forms, the failed-attempt backoff
        resets), then a bridge attempt unless a recent failure backs it
        off by one grouping tick."""
        possible = self._merge_possible()
        if possible and not self._merge_was_possible:
            self._merge_backoff = 0
        self._merge_was_possible = possible
        if possible and self.frame - self._last_merge_try \
                >= self._merge_backoff:
            n_groups = len(np.unique(self.group_id))
            self._last_merge_try = self.frame
            self._try_merge(pyr)
            unified = len(np.unique(self.group_id)) < n_groups
            self._merge_backoff = 0 if unified else 2 * GROUPING_INTERVAL

    def _update_grouping(self):
        """Recompute camera groups with SPLIT hysteresis: a proposal that
        separates co-grouped cameras must persist for two consecutive
        grouping rounds before it is committed (shared observations flap
        around the threshold after occlusions). Joins apply at once; a
        committed split restarts the merge attempts without backoff."""
        shared, area, _, _, _ = self._host_scan()
        gid = camera_grouping(self.state, self.cfg, shared=shared, area=area)
        cur = self.group_id
        C = self.cfg.num_cameras
        splits = any(cur[i] == cur[j] and gid[i] != gid[j]
                     for i in range(C) for j in range(i + 1, C))
        if splits:
            key = tuple(gid.tolist())
            if self._split_pending != key:
                self._split_pending = key
                return
            self._merge_backoff = 0
            self._last_merge_try = -10 ** 9
        self._split_pending = None
        self._set_groups(gid)

    def _set_groups(self, gid: np.ndarray):
        self.group_id = gid
        self.state = self.state._replace(group_id=to_device(gid, self.device))

    def _poses_changed(self):
        """Drop the host copies of the live and keyframe poses."""
        self._pose_host_cache = None
        self._kf_pose_host = None
        self._pose_prefetch = None
        self._kf_prefetch = None

    def _keyframe_ba(self, window: int):
        """A keyframe at the current frame and a BA over ``window``
        keyframes (the merge- and loop-time joint BA)."""
        self.state = self.state._replace(kfs=steps.add_keyframe(self.state))
        self.kf_frames.append(self.frame)
        self._kf_pose_host = None
        self._run_ba(sync=True, window=window)

    def _try_merge(self, pyr):
        """mergeCamGroups: bridge the best candidate pair; on a realigning
        merge, iterate the bridge, fuse duplicates, unify the groups,
        re-register with a widened gate and run the joint wide BA."""
        cfg = self.cfg
        p = cfg.p
        cands = merge_candidates(self.state, cfg, self.K.cpu().numpy(),
                                 self.group_id)
        if not cands:
            return
        cand = cands[0]
        # anchor the group with the more established map: age mass (sum of
        # point ages); an exploring camera mints many fresh points
        mp = self.state.mappts
        status, ptype, owner, first = to_host(mp.status, mp.ptype, mp.owner,
                                              mp.first_frame)
        alive = (status == ST_ALIVE) & (ptype == PT_STATIC)
        grp_owner = self.group_id[np.clip(owner, 0, cfg.num_cameras - 1)]
        mass = alive * np.maximum(self.frame - first, 0)
        n_a = float(mass[grp_owner == self.group_id[cand.cam_a]].sum())
        n_b = float(mass[grp_owner == self.group_id[cand.cam_b]].sum())
        if n_b > n_a:
            cand = MergeCandidate(cam_a=cand.cam_b, cam_b=cand.cam_a,
                                  overlap=cand.overlap)
        # the last frame the two groups were one (0 when never: the
        # reference's fallback)
        f_sep = next((f for f in range(len(self.group_hist) - 1, -1, -1)
                      if self.group_hist[f][cand.cam_a]
                      == self.group_hist[f][cand.cam_b]), 0)
        res = merge_groups(self.state, cfg, pyr, self.K, self.kc,
                           self.group_id, cand, f_sep=f_sep)
        if not res.ok:
            return
        # only committed merges start the merge_min_interval clock
        self._last_merge = self.frame
        ga = self.group_id[cand.cam_a]
        gb = self.group_id[cand.cam_b]
        unified = np.where(self.group_id == gb, ga, self.group_id)
        if res.noop:
            # identity explained the bridge: unify and re-register, no
            # realignment; the wide BA only after a separation long enough
            # to have drifted
            self._set_groups(unified)
            self.state, _ = register_map_points(
                self.state, pyr, self.K, cfg, max_age=p.num_act_frames,
                gate_scale=3.0)
            self.merge_log.append({
                "frame": self.frame, "cam_a": cand.cam_a,
                "cam_b": cand.cam_b, "scale": res.scale,
                "n_matches": res.n_matches, "scale_move": 1.0, "noop": True})
            if self.frame - f_sep > 2 * p.keyframe_min_interval:
                self._keyframe_ba(p.merge_ba_window)
            return
        # bCancelBA: a BA solved against the pre-merge geometry must not
        # write back over the realigned state
        self._cancel_pending_ba()
        self._large_err_until = self.frame + SETTLE_FRAMES
        self.state = res.state
        # Gauss-Newton on the bridge: a thin match set leaves a bas-relief
        # ambiguity; rerun from the realigned pose until the bridge's own
        # no-op test says the pose explains it
        for _ in range(2):
            res_i = merge_groups(self.state, cfg, pyr, self.K, self.kc,
                                 self.group_id, cand, f_sep=f_sep)
            if not res_i.ok or res_i.noop:
                break
            res = res_i._replace(scale=res.scale)
            self.state = res.state
        self.state = fuse_duplicate_points(self.state, cfg, self.group_id,
                                           cand)
        self.merge_log.append({
            "frame": self.frame, "cam_a": cand.cam_a, "cam_b": cand.cam_b,
            "scale": res.scale, "n_matches": res.n_matches,
            "scale_move": res.scale_move})
        self._set_groups(unified)
        # re-form the cross-group observations now, with a widened gate
        self.state, _ = register_map_points(
            self.state, pyr, self.K, cfg, max_age=p.num_act_frames,
            gate_scale=3.0)
        self._poses_changed()
        # joint BA over both groups' separation-era keyframes
        self._keyframe_ba(p.merge_ba_window)

    def _try_loop_closure(self, pyr):
        """Intra-group loop closure on a grouping tick: when a camera's
        view re-covers its own dormant map, re-acquire it, solve the
        drift-free pose and distribute the correction over the drift
        window (slam/loop.py), then BA a wide window at a fresh keyframe.
        Spaced by ``loop_min_interval`` after a closure, out of a merge's
        settle window, with a capped backoff after failed attempts."""
        p = self.cfg.p
        if self.frame - self._last_closure < p.loop_min_interval:
            return
        if self.frame - self._last_loop_attempt < self._loop_backoff:
            return
        if not self._settled():
            return
        # device prefilter: enough dormant points in some view
        dorm_counts = self._host_scan()[4]
        if dorm_counts.max(initial=0) < p.loop_overlap_min:
            self._loop_backoff = GROUPING_INTERVAL
            return
        self._last_loop_attempt = self.frame
        cands = find_loop_candidates(self.state, self.cfg,
                                     self.K.cpu().numpy())
        if not cands:
            return
        res = close_loop(self.state, self.cfg, pyr, self.K, self.kc,
                         self.group_id, cands[0][0])
        if not res.ok:
            self._loop_backoff = min(
                max(2 * GROUPING_INTERVAL, self._loop_backoff * 2),
                4 * GROUPING_INTERVAL)
            return
        self._loop_backoff = GROUPING_INTERVAL
        # the poses were rewritten: an in-flight BA is dropped
        self._cancel_pending_ba()
        self.state = res.state
        self._poses_changed()
        self._last_closure = self.frame
        self._large_err_until = self.frame + SETTLE_FRAMES
        self.loop_log.append({"frame": self.frame, "cam": res.cam,
                              "n_inliers": res.n_inliers,
                              "f_anchor": res.f_anchor, "scale": res.scale})
        self._keyframe_ba(p.merge_ba_window)

    def _keyframe_ready(self, out) -> bool:
        p = self.cfg.p
        if not self.kf_frames:
            return False
        if self.frame - self.kf_frames[-1] < p.keyframe_min_interval:
            return False
        n_inl = np.asarray(out.n_inliers)
        decrease = np.any(n_inl < 0.8 * np.maximum(self._kf_inliers, 1))
        if self._kf_pose_host is None:
            if self._kf_prefetch is not None:
                Rt, self._kf_prefetch = self._kf_prefetch, None
            else:
                KF = self.state.kfs.frame.shape[0]
                kf_idx = (len(self.kf_frames) - 1) % KF
                Rt = _pack_rt(self.state.kfs.R[kf_idx],
                              self.state.kfs.t[kf_idx]).cpu().numpy()
            self._kf_pose_host = (Rt[..., :3].copy(), Rt[..., 3].copy())
        R_kf, t_kf = self._kf_pose_host
        R_cur, t_cur = self._pose_host()
        c_kf = -np.einsum("cji,cj->ci", R_kf, t_kf)
        c_cur = -np.einsum("cji,cj->ci", R_cur, t_cur)
        depth = np.asarray(out.med_depth)
        depth = np.where(np.isfinite(depth) & (depth > 0), depth, 10.0)
        trans = np.linalg.norm(c_cur - c_kf, axis=-1) / depth
        tr = np.einsum("cij,cij->c", R_cur, R_kf)
        ang = np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))
        return bool(decrease or np.any(trans > p.keyframe_trans_ratio)
                    or np.any(ang > p.keyframe_angle_deg))

    def _run_ba(self, sync: bool = False, window: Optional[int] = None):
        """Windowed BA over the dense table. With ``async_ba`` the solve is
        dispatched and applied later (``_poll_ba``), unless ``sync`` (the
        merge and loop polish BAs: the realigned state must not run
        unpolished while a result is in flight); otherwise it is applied at
        once. ``window`` widens the keyframe window (merge- and loop-time
        BA). Never two BAs in flight: a pending one is applied first."""
        cfg = self.cfg
        if self._pending_ba is not None:
            self._apply_pending_ba()
        prob, ring, kf_ok = steps.build_ba_table(self.state, self.K, cfg,
                                                 window=window)
        self.ba_runs += 1
        if self.async_ba and not sync:
            self._pending_ba = self._dispatch_ba(prob, ring, kf_ok)
            return
        self.state = steps.apply_ba_table_results(
            self.state, self._solve_ba(prob), ring, kf_ok, cfg)
        self._pose_host_cache = None
        self._kf_pose_host = None
        self._prefetch_poses()

    def _solve_ba(self, prob):
        p = self.cfg.p
        return bundle_adjust_table(prob, max_err=p.max_err,
                                   max_iter=p.ba_max_iter,
                                   inner_iter=p.ba_inner_iter)

    def _dispatch_ba(self, prob, ring, kf_ok) -> dict:
        """Start an asynchronous solve. On a card it runs on a side stream
        that first waits for the main stream's work so far (the problem's
        tables); the problem's tensors are marked as used there and the
        result's as used on the main stream, so the caching allocator
        reuses neither too early, and an event marks the solve's end. The
        solve has no host sync, so the host goes on tracking while it runs;
        the problem's tables are copies (indexing and concatenation), and
        no step writes into a tensor in place, so tracking changes nothing
        the solve reads. ``gen0`` keeps the slots' generations for the
        write-back guard."""
        gen0 = self.state.mappts.gen.clone()
        done = None
        if self.device.type == "cuda":
            main = torch.cuda.current_stream(self.device)
            if self._ba_stream is None:
                self._ba_stream = torch.cuda.Stream(self.device)
            side = self._ba_stream
            tables_ready = torch.cuda.Event()
            tables_ready.record(main)
            side.wait_event(tables_ready)
            with torch.cuda.stream(side):
                res = self._solve_ba(prob)
                done = torch.cuda.Event()
                done.record(side)
            for x in prob:
                x.record_stream(side)
            for x in res:
                x.record_stream(main)
        else:
            res = self._solve_ba(prob)
        self.ba_async["dispatched"] += 1
        return {"res": res, "ring": ring, "kf_ok": kf_ok, "gen0": gen0,
                "frame": self.frame, "done": done}

    def _apply_pending_ba(self, why: str = "flushed"):
        """Write back the in-flight BA result (async_ba), after the main
        stream waited for the solve's event; point slots re-minted while it
        was in flight are skipped (``gen0``)."""
        pb = self._pending_ba
        if pb is None:
            return
        self._pending_ba = None
        self.ba_async[why] += 1
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).wait_event(pb["done"])
        self.state = steps.apply_ba_table_results(
            self.state, pb["res"], pb["ring"], pb["kf_ok"], self.cfg,
            gen0=pb["gen0"])
        self._pose_host_cache = None
        self._kf_pose_host = None
        self._prefetch_poses()

    def _poll_ba(self, max_defer: int = 8):
        """Apply the in-flight BA once its solve has finished (on a card:
        its event has completed; on the CPU the solve ran at dispatch, so
        the next poll applies it), or after ``max_defer`` frames regardless
        (bounded staleness)."""
        pb = self._pending_ba
        if pb is None:
            return
        if pb["done"] is None or pb["done"].query():
            self._apply_pending_ba("ready")
        elif self.frame - pb["frame"] >= max_defer:
            self._apply_pending_ba("deferred")

    def _cancel_pending_ba(self):
        """bCancelBA: a merge or loop closure rewrote the poses, so a BA in
        flight, solved against the old geometry, is dropped."""
        if self._pending_ba is not None:
            self._pending_ba = None
            self.ba_async["cancelled"] += 1

    def _prefetch_poses(self):
        """Fetch the BA-corrected live pose and the newest keyframe pose in
        one device-to-host copy, for _record_pose and _keyframe_ready."""
        KF = self.state.kfs.frame.shape[0]
        kf_idx = ((len(self.kf_frames) - 1) % KF) if self.kf_frames else 0
        both = torch.stack([
            _pack_rt(self.state.R, self.state.t),
            _pack_rt(self.state.kfs.R[kf_idx], self.state.kfs.t[kf_idx])])
        both = both.cpu().numpy()
        self._pose_prefetch, self._kf_prefetch = both[0], both[1]

    def _store_dynamic_snapshot(self, frame: Optional[int] = None):
        """The alive dynamic points as a log entry (storeDynamicPoints),
        pulled from the device: the non-fused path's snapshot."""
        mp = self.state.mappts
        status, ptype, xyz = to_host(mp.status, mp.ptype, mp.xyz)
        dyn = (status == ST_ALIVE) & (ptype == PT_DYNAMIC)
        ids = np.nonzero(dyn)[0]
        if len(ids):
            self.dyn_log.append((self.frame if frame is None else frame,
                                 ids, xyz[dyn]))

    def _pose_host(self):
        """Current (R, t) as numpy, fetched once per state change."""
        if self._pose_host_cache is None:
            if self._pose_prefetch is not None:
                Rt, self._pose_prefetch = self._pose_prefetch, None
            else:
                Rt = _pack_rt(self.state.R, self.state.t).cpu().numpy()
            self._pose_host_cache = (Rt[..., :3].copy(), Rt[..., 3].copy())
        return self._pose_host_cache

    def _record_pose(self):
        R, t = self._pose_host()
        for c in range(self.cfg.num_cameras):
            if self.traj[c]:
                R_prev, t_prev = self.traj[c][-1]
                Rr = R[c] @ R_prev.T
                self.rel[c].append((Rr, t[c] - Rr @ t_prev))
            self.traj[c].append((R[c].copy(), t[c].copy()))

    # ------------------------------------------------------------------
    def trajectory(self, c: int = 0, correct: bool = True,
                   chain_scales: bool = False):
        """([F,3,3], [F,3]) numpy poses of camera c. With correct=True,
        non-key poses are re-aligned to the final (BA-corrected) keyframe
        poses via the chain pose graph (updateNonKeyCameraPoses). With
        ``chain_scales``, each inter-keyframe segment carries one unknown
        translation scale (uncertainScale): after a merge or loop closure
        rescaled the keyframe anchors, the drift window's raw relative
        translations are still at the old scale, and the chain stretches
        to its anchors instead of distorting. The chunk and overlap
        buffers are drained first."""
        self._flush_chunk()
        self._flush_overlap()
        Rs = np.stack([p[0] for p in self.traj[c]])
        ts = np.stack([p[1] for p in self.traj[c]])
        if not correct or not self.kf_frames:
            return Rs, ts
        F = Rs.shape[0]
        kfs = self.state.kfs
        KF = kfs.frame.shape[0]
        kf_frames = kfs.frame.cpu().numpy()
        kf_R = kfs.R[:, c].cpu().numpy()
        kf_t = kfs.t[:, c].cpu().numpy()
        n_kf = int(kfs.n)
        fixed = np.zeros(F, dtype=bool)
        fixed_R = Rs.copy()
        fixed_t = ts.copy()
        for w in range(min(n_kf, KF)):
            idx = (n_kf - 1 - w) % KF
            f = int(kf_frames[idx])
            if 0 <= f < F:
                fixed[f] = True
                fixed_R[f] = kf_R[idx]
                fixed_t[f] = kf_t[idx]
        fixed[0] = True
        if len(self.rel[c]) != F - 1:
            return Rs, ts
        R_rel = np.stack([r[0] for r in self.rel[c]]) if F > 1 else \
            np.zeros((0, 3, 3), np.float32)
        t_rel = np.stack([r[1] for r in self.rel[c]]) if F > 1 else \
            np.zeros((0, 3), np.float32)
        if F > 512:
            # long runs: consecutive anchors decouple the chain
            return solve_chain_segments(R_rel, t_rel, fixed, fixed_R,
                                        fixed_t, chain_scales=chain_scales,
                                        device=self.device)

        def T(a):
            return torch.as_tensor(a, device=self.device)

        pg = chain_graph(T(R_rel), T(t_rel), T(fixed), T(fixed_R),
                         T(fixed_t), torch.ones(F, dtype=torch.bool,
                                                device=self.device))
        num_scales = 1
        anchors = np.nonzero(fixed)[0]
        if chain_scales and len(anchors) >= 2:
            # edge k (k -> k+1) belongs to the segment between its
            # surrounding anchors; edges outside [first, last) anchor stay
            # rigid (their scale would be unobservable)
            e = np.arange(F - 1)
            seg = np.searchsorted(anchors, e, side="right") - 1
            sg = np.where((e >= anchors[0]) & (e < anchors[-1]), seg, -1)
            num_scales = len(anchors) - 1
            pg = pg._replace(scale_group=T(sg.astype(np.int32)))
        R_sol = solve_rotations(pg)
        t_sol, _ = solve_translations(pg, R_sol, num_scales=num_scales)
        return R_sol.cpu().numpy(), t_sol.cpu().numpy()

    def map_points(self):
        """Alive map points as numpy (id, xyz, cov)."""
        st = self.state.mappts
        alive = (st.status == ST_ALIVE).cpu().numpy()
        ids = np.nonzero(alive)[0]
        return ids, st.xyz.cpu().numpy()[alive], st.cov.cpu().numpy()[alive]
