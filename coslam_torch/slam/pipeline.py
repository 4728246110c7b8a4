"""Host-side engine (the port of the monocular subset of
``coslam_tpu/slam/pipeline.py``).

The per-frame hot path is ``fused.frame_step`` over statically shaped
state on the device; the host reads one packed statistics vector per
tracked frame and makes the cadence decisions: keyframes, windowed BA
(synchronous), periodic duplicate unification. Frame 0 seeds corners; the
two-frame E-matrix bootstrap runs once ``init_frames`` frames are tracked.
Trajectories are chain-corrected to the final keyframe poses at export.

Not ported yet (each raises NotImplementedError naming its ROADMAP.md
item): several cameras (A13), loop closure (A14), the chunked, overlapped,
async-BA and non-fused engine modes (A15), and multi-device meshes (A18).
"""

from __future__ import annotations

import math
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
from coslam_torch.slam.fused import frame_step, pack_stats, unpack_stats
from coslam_torch.slam.merge import fuse_close_points
from coslam_torch.slam.state import (PT_STATIC, ST_ALIVE, SlamState,
                                     init_state)
from coslam_torch.solvers.ba import bundle_adjust_table
from coslam_torch.solvers.pose_graph import (chain_graph,
                                             solve_chain_segments,
                                             solve_rotations,
                                             solve_translations)
from coslam_torch.util import nanmedian, resolve_device, set_drop

# cadence (frames) of the grouping tick, on which the loop check runs
GROUPING_INTERVAL = 5


def _pack_rt(R, t):
    """[..., 3, 3] + [..., 3] -> [..., 3, 4] (one transfer for a pose)."""
    return torch.cat([R, t[..., None]], dim=-1)


class CoSlamEngine:
    """Monocular SLAM engine (the CoSLAM object equivalent, one camera).

    Usage:
        eng = CoSlamEngine(cfg, K, kc)            # on the CUDA device
        for f in range(F):
            stats = eng.process_frame(images[f])  # [1, H, W]
        Rs, ts = eng.trajectory(0)                # corrected

    ``device`` defaults to CUDA and raises when no card is present; pass
    ``device="cpu"`` to run the plain PyTorch path on the CPU."""

    def __init__(self, cfg: SlamConfig, K, kc, device=None,
                 use_fused: bool = True, async_ba: bool = False,
                 overlap: bool = False, chunk: int = 1, mesh=None):
        if cfg.num_cameras > 1:
            raise NotImplementedError(
                "multi-camera SLAM is not ported yet: ROADMAP.md item A13")
        if chunk > 1 or overlap or async_ba or not use_fused:
            raise NotImplementedError(
                "the chunked, overlapped, async-BA and non-fused engine "
                "modes are not ported yet: ROADMAP.md item A15")
        if mesh is not None:
            raise NotImplementedError(
                "multi-device meshes are not ported yet: ROADMAP.md item A18")
        self.cfg = cfg
        self.device = resolve_device(device)
        C = cfg.num_cameras
        K = torch.as_tensor(np.asarray(K, np.float32))
        if tuple(K.shape) != (C, 3, 3):
            raise ValueError(f"K must be [{C}, 3, 3], got {tuple(K.shape)}")
        self.K = K.to(self.device)
        self.kc = torch.as_tensor(np.asarray(kc, np.float32)).to(self.device)
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
        self._last_grouping = -10 ** 9
        self._last_fuse = 0
        self._kf_pose_host = None   # (R, t) of the last keyframe, numpy
        self._pose_host_cache = None
        self._pose_prefetch = None   # packed poses fetched right after BA
        self._kf_prefetch = None

    # ------------------------------------------------------------------
    def process_frame(self, images) -> dict:
        """Feed one frame: images [C, H, W] (numpy or tensor, float32 or
        uint8, 0..255). Returns the frame's statistics."""
        cfg = self.cfg
        self._pose_host_cache = None   # state.R/t will change this frame
        self._pose_prefetch = None
        self._kf_prefetch = None
        imgs = torch.as_tensor(images).to(self.device).to(torch.float32)
        if self.bootstrapped and self.frame > 0:
            self.state, pyr, fs = frame_step(
                self.state, self.pyr_prev, imgs, self.K, self.kc, cfg)
            stats = {"frame": self.frame}
            stats.update(self._host_cadence(pyr, pack_stats(fs)))
        else:
            pyr = build_pyramid(imgs, cfg.klt.n_levels)
            stats = {"frame": self.frame}
            if self.frame == 0:
                self._first_frame(pyr)
            else:
                self.state = self.state._replace(
                    tracks=steps.advance_tracks(
                        self.pyr_prev, pyr, self.state.tracks, self.K,
                        self.kc, self.state.frame + 1, cfg),
                    frame=self.state.frame + 1)
                if self.frame >= cfg.p.init_frames:
                    stats["bootstrap"] = self._bootstrap(pyr)
        self._record_pose()
        self.pyr_prev = pyr
        self.frame += 1
        stats.setdefault("n_inliers", np.zeros(cfg.num_cameras))
        self.stats_log.append(stats)
        return stats

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
    def _host_cadence(self, pyr, fsv: torch.Tensor) -> dict:
        """Tracked-frame cadence: ONE device-to-host copy (the packed stats,
        post-step poses included), then the shared cadence."""
        fs = unpack_stats(fsv.cpu(), self.cfg.num_cameras,
                          self.state.kfs.dyn_xyz.shape[1])
        self._pose_host_cache = (fs.R.copy(), fs.t.copy())
        return self._shared_cadence(pyr, fs, n_mapped=fs.n_mapped,
                                    n_new=int(fs.n_new_points),
                                    frame=self.frame)

    def _shared_cadence(self, pyr, out, n_mapped: np.ndarray, n_new: int,
                        frame: int) -> dict:
        """Host-decided per-frame work: the loop-closure check on the
        grouping cadence, keyframes + BA, duplicate unification."""
        cfg = self.cfg
        n_inl = np.asarray(out.n_inliers)
        grouping_due = self.frame - self._last_grouping >= GROUPING_INTERVAL
        if grouping_due:
            self._last_grouping = self.frame
            self._try_loop_closure(pyr)
        stats = {
            "n_inliers": n_inl,
            "coverage": np.asarray(out.coverage),
            "med_err": np.asarray(out.med_err),
            "med_depth": np.asarray(out.med_depth),
            "n_new_points": n_new,
            "n_intercam_points": 0,
            "joint_pose": False,
        }
        if self._keyframe_ready(out):
            self.state = self.state._replace(
                kfs=steps.add_keyframe(self.state))
            self.kf_frames.append(self.frame)
            self._kf_inliers = n_inl.copy()
            self._kf_pose_host = self._pose_host()
            if len(self.kf_frames) % cfg.p.ba_cadence == 0:
                self._run_ba()
            stats["keyframe"] = True
        # periodic duplicate unification (every 50th frame)
        if self.frame - self._last_fuse >= 50:
            self._last_fuse = self.frame
            self.state, n_fused = fuse_close_points(self.state, cfg)
            if n_fused:
                stats["n_fused"] = n_fused
        return stats

    def _try_loop_closure(self, pyr):
        """Intra-group loop closure: reached on a grouping tick once
        ``loop_min_interval`` frames have passed (since frame 0: no closure
        has run)."""
        p = self.cfg.p
        if self.frame < p.loop_min_interval:
            return
        raise NotImplementedError(
            f"loop closure is not ported yet (reached at frame {self.frame}, "
            f"loop_min_interval={p.loop_min_interval}): ROADMAP.md item A14")

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

    def _run_ba(self):
        """Synchronous windowed BA over the dense table, then write-back."""
        cfg = self.cfg
        prob, ring, kf_ok = steps.build_ba_table(self.state, self.K, cfg)
        res = bundle_adjust_table(prob, max_err=cfg.p.max_err,
                                  max_iter=cfg.p.ba_max_iter,
                                  inner_iter=cfg.p.ba_inner_iter)
        self.state = steps.apply_ba_table_results(self.state, res, ring,
                                                  kf_ok, cfg)
        self.ba_runs += 1
        self._pose_host_cache = None
        self._kf_pose_host = None
        self._prefetch_poses()

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
    def trajectory(self, c: int = 0, correct: bool = True):
        """([F,3,3], [F,3]) numpy poses of camera c. With correct=True,
        non-key poses are re-aligned to the final (BA-corrected) keyframe
        poses via the chain pose graph (updateNonKeyCameraPoses). The
        reference's per-segment scales (``chain_scales``) follow merges
        and loop closures, which are not ported yet (ROADMAP.md A14)."""
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
                                        fixed_t, device=self.device)

        def T(a):
            return torch.as_tensor(a, device=self.device)

        pg = chain_graph(T(R_rel), T(t_rel), T(fixed), T(fixed_R),
                         T(fixed_t), torch.ones(F, dtype=torch.bool,
                                                device=self.device))
        R_sol = solve_rotations(pg)
        t_sol, _ = solve_translations(pg, R_sol)
        return R_sol.cpu().numpy(), t_sol.cpu().numpy()

    def map_points(self):
        """Alive map points as numpy (id, xyz, cov)."""
        st = self.state.mappts
        alive = (st.status == ST_ALIVE).cpu().numpy()
        ids = np.nonzero(alive)[0]
        return ids, st.xyz.cpu().numpy()[alive], st.cov.cpu().numpy()[alive]
