"""The comparison that decides ``correct``.

Snapshots of the engine's state are taken inside the window, between
``process_frame`` calls (device copies, no host wait), at calls drawn
from the seed; everything is judged after the window has closed.

- Tracked step (pyramid, KLT tracks, pose update, static/dynamic
  classification): from the program's state before a call, the frozen
  plain step (``reference/frozen``) runs the call's frames again, on
  pyramids it builds itself from the benchmark's own images, and is held
  against what the program produced: its pyramid (``pyr_abs``, grey
  levels), the positions of the tracks valid on both sides
  (``klt_px``, the 99th percentile of the gap in px), every camera's
  pose after the call's first frame (``pose_deg``, ``pose_ctr``:
  rotation angle and centre distance in world units, the room being 20
  units wide), every camera's pose at a chunk's later frames
  (``pose_deg_chain``, ``pose_ctr_chain``: each side chains its own
  rounding through the frames, and where a tracked point's decision
  flips on it the two sides part by some hundredths of a degree, as the
  reference on the GPU and on the CPU do, so the limit is wider) and
  the type of every map point alive on both sides (``ptype_share``, the
  share that differs).
- Keyframe BA: the state a sampled windowed BA started from is caught
  where the port builds the BA's table (``slam.steps.build_ba_table``);
  the frozen plain BA (table, solve, write-back) runs from it, and the
  final robust cost of each side's solution on the reference's table is
  compared: its relative gap, the median (the lower middle one of an
  even count) over the sampled BAs (``ba_cost_median``). Not the poses
  and points themselves: rounding can steer the solve's accepted steps
  apart, and points that two views hardly fix then part along
  directions the cost does not see. Not the worst BA: where one point
  has two observations in one (keyframe, camera) slot, the table's
  write that wins is unspecified on CUDA, and the reference run twice
  on one state has read solutions a percent apart on one BA of a
  window, while the others read 0; the TF32 control parts every BA.

The reference follows the program step by step from its own state; the
start (bootstrap) is not compared.
"""

from __future__ import annotations

import contextlib
import math
import sys

import numpy as np
import torch

# name -> (unit, limit); a number is correct when it is at most its limit.
# Each limit lies between the most that sound runs read on the H100 and
# the least that the TF32 control or a planted fault reads (PERF.md,
# section 2, gives the readings): the pyramid reads 0 on sound runs and
# 1 grey with one grey level planted, and its limit leaves a kernel room
# to round otherwise; the other step numbers sit far above the sound
# runs' reading and well under the faults'; the BA's replay is exact on
# most sound runs and TF32 moves every BA.
LIMITS = {
    "pyr_abs": ("grey", 1e-3),
    "klt_px": ("px", 0.01),
    "pose_deg": ("deg", 0.01),
    "pose_ctr": ("units", 0.002),
    "pose_deg_chain": ("deg", 0.2),
    "pose_ctr_chain": ("units", 0.03),
    "ptype_share": ("share", 0.01),
    "ba_cost_median": ("share", 1.5e-3),
}


def clone_tree(x):
    """A device copy of every tensor in a (named) tuple tree."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[clone_tree(v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(clone_tree(v) for v in x)
    return x


def to_frozen(x, classes: dict):
    """The program's (named) tuple tree as the frozen package's types, by
    class name (the port's state layout is the reference's)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        cls = classes[type(x).__name__]
        return cls(**{k: to_frozen(getattr(x, k), classes)
                      for k in x._fields})
    if isinstance(x, (tuple, list)):
        return type(x)(to_frozen(v, classes) for v in x)
    return x


@contextlib.contextmanager
def plain_float32():
    """True float32 matmuls while the reference runs, whatever the
    program set."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def frozen_config(cfg_json: dict):
    """The configuration file as the frozen package's SlamConfig."""
    from slambench.reference.frozen import config as fc
    return fc.SlamConfig(
        num_cameras=cfg_json["num_cameras"],
        image_height=cfg_json["image_height"],
        image_width=cfg_json["image_width"],
        klt=fc.KLTConfig(**cfg_json["klt"]),
        cap=fc.CapacityConfig(**cfg_json["cap"]),
        p=fc.SlamParams(**cfg_json["p"]))


def _classes():
    from slambench.reference.frozen.ops import pyramid
    from slambench.reference.frozen.slam import state
    out = {n: getattr(state, n) for n in dir(state)
           if isinstance(getattr(state, n), type)}
    out["Pyramid"] = pyramid.Pyramid
    return out


def _rot_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle between rotations from their chord, ||Ra - Rb||_F = 2 sqrt(2)
    sin(angle / 2) (arccos of the trace is blind below ~0.03 deg in
    float32)."""
    d = np.linalg.norm((Ra.astype(np.float64) - Rb.astype(np.float64))
                       .reshape(*Ra.shape[:-2], 9), axis=-1)
    return np.degrees(2.0 * np.arcsin(np.clip(d / (2.0 * np.sqrt(2.0)),
                                              0.0, 1.0)))


def _centre(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return -np.einsum("...ji,...j->...i", R.astype(np.float64),
                      t.astype(np.float64))


class Reference:
    """The frozen plain path at a cell's configuration, on ``device``."""

    def __init__(self, cfg_json: dict, K: np.ndarray, device):
        self.cfg = frozen_config(cfg_json)
        self.device = torch.device(device)
        self.K = torch.as_tensor(K, device=self.device)
        self.kc = torch.as_tensor(
            np.broadcast_to(np.asarray(cfg_json["distortion"], np.float32),
                            (cfg_json["num_cameras"], 5)).copy(),
            device=self.device)
        self.classes = _classes()

    def pyramid(self, img_u8):
        from slambench.reference.frozen.ops.pyramid import build_pyramid
        img = torch.as_tensor(img_u8).to(self.device, torch.float32)
        return build_pyramid(img, self.cfg.klt.n_levels)

    def step_readings(self, snap: dict, frames) -> dict:
        """Replay a snapshot's frames from its state before the call;
        returns the step's numbers (and the poses it made by frame)."""
        from slambench.reference.frozen.slam.fused import frame_step
        f0, n = snap["f0"], snap["n"]
        st = to_frozen(snap["before"], self.classes)
        pyr = self.pyramid(frames[f0 - 1])
        poses = {}
        with plain_float32():
            for f in range(f0, f0 + n):
                imgs = torch.as_tensor(frames[f]).to(self.device,
                                                     torch.float32)
                st, pyr, _ = frame_step(st, pyr, imgs, self.K, self.kc,
                                        self.cfg)
                poses[f] = (st.R.cpu().numpy(), st.t.cpu().numpy())
        out = {"poses": poses}
        prog_pyr = snap["pyr_after"]
        out["pyr_abs"] = max(
            float((a.to(self.device) - b).abs().max())
            for a, b in zip(prog_pyr.imgs + prog_pyr.dxs + prog_pyr.dys,
                            pyr.imgs + pyr.dxs + pyr.dys))
        tb, ta = snap["before"].tracks, snap["after"].tracks
        both = (tb.valid.to(self.device) & ta.valid.to(self.device)
                & st.tracks.valid)
        gap = torch.linalg.norm(ta.pos.to(self.device) - st.tracks.pos,
                                dim=-1)[both]
        out["klt_px"] = (float(torch.quantile(gap.double(), 0.99))
                         if gap.numel() else None)
        from slambench.reference.frozen.slam.state import ST_ALIVE
        alive_state = ST_ALIVE
        mb, ma = snap["before"].mappts, snap["after"].mappts
        alive = ((mb.status == alive_state) & (ma.status == alive_state)
                 ).to(self.device) & (st.mappts.status == alive_state)
        n_alive = int(alive.sum())
        out["ptype_share"] = (float((ma.ptype.to(self.device)
                                     != st.mappts.ptype)[alive].sum())
                              / n_alive if n_alive else None)
        return out

    def _ba_cost_gap(self, prob, new, after, ring) -> float:
        """|E(program) - E(reference)| / E(reference): the windowed BA's
        final robust cost (Tukey-weighted reprojection, as the solver
        scores its result) of each side's solution on the reference's
        table, in float64."""
        from slambench.reference.frozen.geometry.robust import tukey_weight
        from slambench.reference.frozen.solvers.ba import _residuals
        P = after.mappts.xyz.shape[0]
        S = prob.R.shape[0]
        d = torch.float64

        def cost(R, t, Xp):
            X = torch.cat([Xp.to(self.device, d), prob.X[P:].to(d)]).T
            ru, rv, z, _, _ = _residuals(prob.K.to(d), R.to(d), t.to(d), X,
                                         prob.obs_px.to(d))
            err = torch.hypot(ru, rv)
            w = prob.obs_valid.to(d) * tukey_weight(err, self.cfg.p.max_err) \
                * (z > 1e-6)
            return float(torch.sum(w * (ru * ru + rv * rv)))

        def side(st):
            return (st.kfs.R.to(self.device)[ring].reshape(S, 3, 3),
                    st.kfs.t.to(self.device)[ring].reshape(S, 3),
                    st.mappts.xyz)

        e_ref = cost(*side(new))
        e_prog = cost(*side(after))
        return abs(e_prog - e_ref) / max(e_ref, 1e-12)

    def ba_readings(self, before, after) -> dict:
        """The frozen plain windowed BA (table, solve, write-back) from the
        state the program's BA started from, held against the state the
        program's BA left. Returned: ``ba_cost``, whose median over the
        sampled BAs is compared. Logged beside it: the
        window's keyframe centre gap and the quantiles of the gap of the
        map points either side moved."""
        from slambench.reference.frozen.slam.state import ST_ALIVE
        from slambench.reference.frozen.slam.steps import (
            apply_ba_table_results, build_ba_table)
        from slambench.reference.frozen.solvers.ba import bundle_adjust_table
        st = to_frozen(before, self.classes)
        p = self.cfg.p
        with plain_float32():
            prob, ring, kf_ok = build_ba_table(st, self.K, self.cfg)
            res = bundle_adjust_table(prob, max_err=p.max_err,
                                      max_iter=p.ba_max_iter,
                                      inner_iter=p.ba_inner_iter)
            new = apply_ba_table_results(st, res, ring, kf_ok, self.cfg)
        dev = self.device
        win = ring[kf_ok]
        detail = {}
        if win.numel():
            c_ref = _centre(new.kfs.R[win].cpu().numpy(),
                            new.kfs.t[win].cpu().numpy())
            c_prog = _centre(after.kfs.R.to(dev)[win].cpu().numpy(),
                             after.kfs.t.to(dev)[win].cpu().numpy())
            detail["centre_gap"] = float(np.linalg.norm(c_ref - c_prog,
                                                        axis=-1).max())
        x0 = st.mappts.xyz
        xa = after.mappts.xyz.to(dev)
        alive = (new.mappts.status == ST_ALIVE) & \
            (after.mappts.status.to(dev) == ST_ALIVE)
        moved = alive & ((new.mappts.xyz != x0).any(-1) | (xa != x0).any(-1))
        gap = torch.linalg.norm(new.mappts.xyz - xa, dim=-1)[moved]
        if gap.numel():
            detail["moved_points"] = int(moved.sum())
            detail["point_gap_q50_q90_q99_max"] = torch.quantile(
                gap.double(), torch.tensor([0.5, 0.9, 0.99, 1.0],
                                           dtype=torch.float64,
                                           device=dev)).tolist()
        return {"ba_cost": self._ba_cost_gap(prob, new, after, ring),
                "_detail": detail}


def judge(snaps: list, bas: list, frames, traj, cfg_json: dict, K,
          device) -> tuple[dict, dict]:
    """Run the reference over the sampled step snapshots and BA captures
    (``bas``: the state each sampled windowed BA started from and the
    state after its call). ``traj``: the engine's recorded poses by
    camera (``eng.traj``). Returns ({number: worst reading}, {"steps":
    frames replayed, "ba": BA windows rerun})."""
    ref = Reference(cfg_json, K, device)
    C = cfg_json["num_cameras"]
    worst: dict = {}

    def note(name, v):
        if v is not None and (name not in worst or v > worst[name]
                              or math.isnan(v)):
            worst[name] = v

    for s in snaps:
        r = ref.step_readings(s, frames)
        for k in ("pyr_abs", "klt_px", "ptype_share"):
            note(k, r[k])
        chained = []
        for f, (R, t) in r["poses"].items():
            if f not in s["pose_frames"] or len(traj[0]) <= f:
                continue
            Rp = np.stack([traj[c][f][0] for c in range(C)])
            tp = np.stack([traj[c][f][1] for c in range(C)])
            deg = float(_rot_deg(Rp, R).max())
            ctr = float(np.linalg.norm(_centre(Rp, tp) - _centre(R, t),
                                       axis=-1).max())
            chain = "" if f == s["f0"] else "_chain"
            note("pose_deg" + chain, deg)
            note("pose_ctr" + chain, ctr)
            chained.append((f - s["f0"], round(deg, 6), round(ctr, 7)))
        if len(chained) > 1:
            print(f"[slambench] chunk from frame {s['f0']}: pose gaps "
                  f"(frame, deg, units) {chained}", file=sys.stderr)
    gaps = []
    for b in bas:
        r = ref.ba_readings(b["before"], b["after"])
        print(f"[slambench] BA replay: cost gap {r['ba_cost']!r}, "
              f"{r['_detail']}", file=sys.stderr)
        gaps.append(r["ba_cost"])
    if gaps:
        note("ba_cost_median", median_low(gaps))
    return worst, {"steps": sum(s["n"] for s in snaps), "ba": len(bas)}


def median_low(values: list) -> float:
    """The median of ``values``, the lower middle one of an even count;
    NaN where any is NaN."""
    if any(math.isnan(v) for v in values):
        return math.nan
    return sorted(values)[(len(values) - 1) // 2]


def verdict(worst: dict, counts: dict, caps: dict) -> tuple[bool, dict]:
    """``correct`` and the compared numbers with their limits. A run with
    no tracked step compared is not correct, nor one with fewer keyframe
    BAs compared than the traffic's ``check`` block asks (``min_ba``:
    the TF32 control shows only there); a NaN reading fails."""
    shown = {k: {"value": worst[k], "limit": LIMITS[k][1],
                 "unit": LIMITS[k][0]} for k in LIMITS if k in worst}
    ok = (counts["steps"] > 0 and counts["ba"] >= caps.get("min_ba", 0)
          and all(not math.isnan(v["value"]) and v["value"] <= v["limit"]
                  for v in shown.values()))
    return ok, shown
