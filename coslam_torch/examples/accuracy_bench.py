"""Production-scale accuracy harness of coslam_torch -> ACCURACY.md (the
port of ``examples/accuracy_bench.py``, config for config).

Long synthetic sequences at the BASELINE configs' production shape
(640x480, hundreds of frames): the textured room, forward and yaw
trajectories, a moving object, cameras that part and meet, a covered
lens, radial distortion. The ground truth is pure numpy; the frames are
rendered on the engine's device and rounded to float16 before first use,
as the reference does. The reference's disk cache of rendered scenes is
not kept: a scene always draws from the generator in the order of the
reference's cache miss.

Usage:
    python -m coslam_torch.examples.accuracy_bench [config ...]
        [--frames N] [--small] [--cpu] [--out DIR]

Configs: mono, twocam, threecam_dyn, splitmerge, distorted, mono_loop,
occlusion (the default sweep) and fivecam_mesh (only when named). Runs on
the CUDA card unless given ``--cpu``. Writes ACCURACY.md and
ACCURACY.json under ``--out`` (default ``build/accuracy``), merging new
rows over the rows already there, after every config.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

from coslam_torch.ops import kernel_wrappers
from coslam_torch.util import BUILD_ROOT, resolve_device

H, W = 480, 640
K1 = np.array([[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1]],
              dtype=np.float32)
OUT_DIR = str(BUILD_ROOT / "accuracy")


def _cfg(C):
    from coslam_torch.config import CapacityConfig, KLTConfig, SlamConfig
    return SlamConfig(
        num_cameras=C, image_height=H, image_width=W,
        klt=KLTConfig(n_levels=4),
        cap=CapacityConfig(max_features=1024, max_map_points=8192,
                           max_keyframes=64, ba_window=5))


def _rig_frames(rng, C, F, baseline=1.0, forward=0.04, quads=None,
                yaw_fn=None, kc=None, hw=None, K=None, device=None):
    """Render a C-camera rig sequence on ``device``. Returns (frames
    [F, C, H, W] float32 tensor holding float16 values, Rs_gt
    [C, F, 3, 3], ts_gt [C, F, 3]).

    The poses are pure numpy (so3_exp_np); the generator is drawn as the
    reference's cache miss draws it: one uniform (its cache key), then the
    room's textures."""
    from coslam_torch.geometry.se3 import so3_exp_np
    from coslam_torch.io.synthetic import (apply_distortion_warp, make_room,
                                           multi_cam_rig, orbit_trajectory,
                                           render_batch)
    h_img, w_img = hw or (H, W)
    K = K1 if K is None else K
    Rr, tr = orbit_trajectory(F, forward=forward)
    rot_c, offs_c = multi_cam_rig(C, baseline=baseline)
    Rs_gt = np.zeros((C, F, 3, 3), np.float32)
    ts_gt = np.zeros((C, F, 3), np.float32)
    for f in range(F):
        c_rig = -Rr[f].T @ tr[f]
        for c in range(C):
            center = c_rig + Rr[f].T @ offs_c[c]
            Rc = rot_c[c] @ Rr[f]
            if yaw_fn is not None:
                yaw = yaw_fn(c, f)
                if yaw:
                    Rc = so3_exp_np(np.array([0.0, yaw, 0.0])) @ Rc
            Rs_gt[c, f] = Rc
            ts_gt[c, f] = -Rc @ center
    rng.uniform()                  # the reference's cache key draw
    planes = make_room(rng, size=10.0)
    Rflat = Rs_gt.transpose(1, 0, 2, 3).reshape(F * C, 3, 3)
    tflat = ts_gt.transpose(1, 0, 2).reshape(F * C, 3)
    fidx = np.repeat(np.arange(F), C)
    frames = render_batch(planes, K, Rflat, tflat, h_img, w_img,
                          quads=quads, frames=fidx, chunk=4 * C,
                          device=device).reshape(F, C, h_img, w_img)
    if kc is not None:
        for c in range(C):
            if np.any(kc[c]):
                frames[:, c] = apply_distortion_warp(frames[:, c], K, kc[c])
    # rounded to float16 before first use, as the reference's frames are
    return frames.half().float(), Rs_gt, ts_gt


def _cards(eng) -> list[torch.device]:
    """The CUDA devices an engine runs on (its mesh's, or its own)."""
    devs = eng.mesh.devices if eng.mesh is not None else [eng.device]
    return list(dict.fromkeys(d for d in devs if d.type == "cuda"))


def _run(name, C, frames, Rs_gt, ts_gt, kc=None, cfg_mut=None,
         mesh=None, K=None, eval_from=0, device=None, engines=None):
    """Drive the chunked engine (chunk=6) over ``frames`` [F, C, H, W],
    staged on the engine's device as one float16 tensor, and score it.
    Returns the row: the reference's keys, plus ``peak_mem_mib`` (the
    most the run's cards held, None on the CPU) and ``launches`` (each
    kernel's launches during the run). ``engines``, a dict, receives the
    engine under ``name``."""
    from coslam_torch.io.ate import ate_rmse
    from coslam_torch.slam.pipeline import CoSlamEngine
    cfg = _cfg(C)
    if cfg_mut is not None:
        cfg = cfg_mut(cfg)
    K = np.stack([K1 if K is None else K] * C)
    kc = np.zeros((C, 5), np.float32) if kc is None else kc
    eng = CoSlamEngine(cfg, K, kc, chunk=6, mesh=mesh, device=device)
    cards = _cards(eng)
    F = frames.shape[0]
    # the whole sequence resident on the device as float16 (a frame a
    # view of it: the engine converts each frame into a tensor of its own)
    stage = torch.as_tensor(frames).to(eng.device, torch.float16)
    counters = kernel_wrappers()
    for fn in counters.values():
        fn.launches = 0
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    for f in range(F):
        eng.process_frame(stage[f])
        if f % 100 == 0:
            print(f"  [{name}] frame {f}/{F}", flush=True)
    eng._flush_chunk()
    for d in cards:             # the card's time, not the launch queue's
        torch.cuda.synchronize(d)
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = max((torch.cuda.max_memory_allocated(d) for d in cards),
               default=None)
    del stage
    ates = []
    for c in range(C):
        Rs, ts = eng.trajectory(c, correct=True, chain_scales=True)
        # eval_from > 0: score only the tail (a designed information
        # blackout carries nothing an estimator could match)
        ates.append(ate_rmse(Rs[eval_from:], ts[eval_from:],
                             Rs_gt[c, eval_from:], ts_gt[c, eval_from:]))
    # path length of camera 0 (for a scale-free drift percentage)
    ctr = -np.einsum("fji,fj->fi", Rs_gt[0], ts_gt[0])
    path = float(np.linalg.norm(np.diff(ctr, axis=0), axis=1).sum())
    row = {
        "config": name, "cams": C, "frames": F,
        "shape": f"{frames.shape[3]}x{frames.shape[2]}",
        "ate": [round(float(a), 4) for a in ates],
        "ate_max": round(float(max(ates)), 4),
        "ate_pct_path": round(100 * float(max(ates)) / max(path, 1e-6), 2),
        "path_len": round(path, 2),
        "fps": round(F / dt, 2),
        "n_merges": len(eng.merge_log),
        "merges_noop": [bool(m.get("noop", False)) for m in eng.merge_log],
        "n_loops": len(eng.loop_log),
        "n_keyframes": len(eng.kf_frames),
    }
    if eval_from:
        row["eval_from"] = eval_from
    row["peak_mem_mib"] = None if peak is None else round(peak / 2 ** 20, 1)
    row["launches"] = launches
    print(f"  [{name}] ATE={row['ate']} ({row['ate_pct_path']}% of "
          f"{path:.1f}u path) fps={row['fps']}", flush=True)
    # engine wall-clock breakdown: where the long run spends its time
    tt = sorted(eng.timing.items(), key=lambda kv: -kv[1])
    tot = sum(eng.timing.values())
    print(f"  [{name}] timing total {tot:.1f}s over {dt:.1f}s wall: "
          + " ".join(f"{k}={v:.1f}" for k, v in tt[:12]), flush=True)
    # group split/merge evidence: every group-id transition
    trans = []
    for i in range(1, len(eng.group_hist)):
        if eng.group_hist[i] != eng.group_hist[i - 1]:
            trans.append((i, eng.group_hist[i]))
    if trans or eng.merge_log or eng.loop_log:
        print(f"  [{name}] group transitions={trans} "
              f"merges={eng.merge_log} loops={eng.loop_log}", flush=True)
    print(f"  [{name}] peak device memory {row['peak_mem_mib']} MiB, "
          f"kernel launches {launches}", flush=True)
    if engines is not None:
        engines[name] = eng
    return row


def config_mono(F, rng, device=None, engines=None):
    frames, Rs, ts = _rig_frames(rng, 1, F, forward=0.04, device=device)
    return _run("mono", 1, frames, Rs, ts, device=device, engines=engines)


def config_twocam(F, rng, device=None, engines=None):
    frames, Rs, ts = _rig_frames(rng, 2, F, baseline=1.0, forward=0.04,
                                 device=device)
    return _run("twocam", 2, frames, Rs, ts, device=device, engines=engines)


def config_threecam_dyn(F, rng, device=None, engines=None):
    from coslam_torch.io.synthetic import MovingQuad, make_texture
    quad = MovingQuad(
        center0=np.array([-3.0, 0.5, 14.0], np.float32),
        velocity=np.array([0.012, 0.0, 0.0], np.float32),
        eu=np.array([1.6, 0, 0], np.float32),
        ev=np.array([0, 1.6, 0], np.float32),
        tex=make_texture(rng))
    frames, Rs, ts = _rig_frames(rng, 3, F, baseline=1.0, forward=0.04,
                                 quads=[quad], device=device)
    return _run("threecam_dyn", 3, frames, Rs, ts, device=device,
                engines=engines)


def config_mono_loop(F, rng, device=None, engines=None):
    """Monocular revisit: map the back wall with a lateral sweep, yaw away
    ~69 deg past the dormancy age, return and dwell: the loop closure must
    re-acquire the dormant wall map (default closure thresholds). A
    control run with closure attempts gated off gives
    ``ate_noloop_control``."""
    from coslam_torch.geometry.se3 import so3_exp_np
    from coslam_torch.io.synthetic import make_room, render_batch
    f_map, f_out, f_back = int(F * 0.15), int(F * 0.30), int(F * 0.82)
    f_home = int(F * 0.92)
    yaws = np.concatenate([
        np.zeros(f_map),                                   # map the wall
        np.linspace(0, 1.2, f_out - f_map),                # yaw away
        np.full(f_back - f_out, 1.2),                      # dwell away
        np.linspace(1.2, 0.0, f_home - f_back),            # yaw back
        np.zeros(F - f_home),                              # revisit dwell
    ])[:F]
    Rs_gt = np.zeros((1, F, 3, 3), np.float32)
    ts_gt = np.zeros((1, F, 3), np.float32)
    for f in range(F):
        R = so3_exp_np(np.array([0.0, yaws[f], 0.0]))
        c = np.array([0.9 * np.sin(0.06 * f), 0.05 * np.sin(0.1 * f),
                      0.002 * f], dtype=np.float32)
        Rs_gt[0, f] = R
        ts_gt[0, f] = (-R @ c).astype(np.float32)
    rng.uniform()                  # the reference's cache key draw
    planes = make_room(rng, size=10.0)
    frames = render_batch(planes, K1, Rs_gt[0], ts_gt[0], H, W, chunk=8,
                          device=device).half().float()[:, None]
    row = _run("mono_loop", 1, frames, Rs_gt, ts_gt, device=device,
               engines=engines)
    # loop-disabled control: the same sequence, closure attempts gated
    # off: what the Sim(3) loop correction buys at production scale
    ctrl = _run("mono_loop_ctrl", 1, frames, Rs_gt, ts_gt,
                cfg_mut=lambda c: dataclasses.replace(
                    c, p=dataclasses.replace(c.p,
                                             loop_min_interval=10 ** 9)),
                device=device, engines=engines)
    row["ate_noloop_control"] = ctrl["ate_max"]
    return row


def config_occlusion(F, rng, device=None, engines=None):
    """Camera blackout and recovery: camera 1's lens is covered (noise
    frames) for 20% of the run while the rig keeps moving. Tracking dies,
    the pose carries, the group splits; on uncover camera 1 restarts from
    a stale pose and the merge bridge must realign it onto the anchor map
    (a non-noop Sim(3) correction). ATE is scored from 20 frames after
    uncover."""
    frames, Rs, ts = _rig_frames(rng, 2, F, baseline=1.0, forward=0.04,
                                 device=device)
    f0, f1 = int(F * 0.25), int(F * 0.45)
    frames = frames.clone()
    noise = rng.uniform(0, 30, tuple(frames[f0:f1, 1].shape))
    frames[f0:f1, 1] = torch.from_numpy(noise.astype(np.float32)).to(
        frames.device)
    return _run("occlusion", 2, frames, Rs, ts, eval_from=f1 + 20,
                device=device, engines=engines)


def config_fivecam_mesh(F, rng, device=None, engines=None):
    """BASELINE config 5 end to end: the full engine on a 5-device camera
    mesh, one camera a shard, at the reference's 240x320. On one card the
    mesh is ``["cuda:0"] * 5`` and the ``step_scaling`` rows time a
    repeated-device mesh, not scaling."""
    from coslam_torch.parallel.mesh import make_cam_mesh, round_robin
    from coslam_torch.parallel.scaling import step_scaling
    h2, w2 = 240, 320
    K2 = np.array([[250.0, 0, w2 / 2], [0, 250.0, h2 / 2], [0, 0, 1]],
                  dtype=np.float32)
    frames, Rs, ts = _rig_frames(rng, 5, F, baseline=0.8, forward=0.04,
                                 hw=(h2, w2), K=K2, device=device)
    devices = round_robin(5, device)
    print(f"  [fivecam_mesh] mesh devices {devices}", flush=True)
    mesh = make_cam_mesh(5, devices=devices)
    row = _run("fivecam_mesh", 5, frames, Rs, ts, K=K2, mesh=mesh,
               cfg_mut=lambda c: dataclasses.replace(
                   c, image_height=h2, image_width=w2),
               device=mesh.main, engines=engines)
    row["mesh_devices"] = devices
    row["step_scaling"] = step_scaling(device_counts=(1, 2, 4), n_cams=8,
                                       h=h2, w=w2, iters=4,
                                       devices=round_robin(4, device))
    return row


def config_splitmerge(F, rng, device=None, engines=None):
    sep0, sep1 = int(F * 0.2), int(F * 0.4)
    ret0, ret1 = int(F * 0.55), int(F * 0.75)
    # 1.2 rad (69 deg) exceeds the 65-deg horizontal FOV at 640x480
    # (fx=500): the views stop overlapping, so the grouping split and the
    # merge machinery fire at production shape
    max_yaw = 1.2

    def yaw_fn(c, f):
        if c != 1:
            return 0.0
        if f < sep0:
            return 0.0
        if f < sep1:
            return max_yaw * (f - sep0) / (sep1 - sep0)
        if f < ret0:
            return max_yaw
        if f < ret1:
            return max_yaw * (ret1 - f) / (ret1 - ret0)
        return 0.0

    frames, Rs, ts = _rig_frames(rng, 2, F, baseline=1.0, forward=0.02,
                                 yaw_fn=yaw_fn, device=device)
    return _run("splitmerge", 2, frames, Rs, ts, device=device,
                engines=engines)


def config_distorted(F, rng, device=None, engines=None):
    kc = np.zeros((3, 5), np.float32)
    kc[:, 0] = -0.25           # k1 radial (typical webcam barrel)
    kc[:, 1] = 0.08            # k2
    frames, Rs, ts = _rig_frames(rng, 3, F, baseline=1.0, forward=0.04,
                                 kc=kc, device=device)
    return _run("distorted", 3, frames, Rs, ts, kc=kc, device=device,
                engines=engines)


CONFIGS = {
    "mono": config_mono,
    "twocam": config_twocam,
    "threecam_dyn": config_threecam_dyn,
    "splitmerge": config_splitmerge,
    "distorted": config_distorted,
    "mono_loop": config_mono_loop,
    "occlusion": config_occlusion,
    "fivecam_mesh": config_fivecam_mesh,
}
DEFAULT_FRAMES = {"mono": 500, "twocam": 500, "threecam_dyn": 500,
                  "splitmerge": 400, "distorted": 300, "mono_loop": 400,
                  "occlusion": 300, "fivecam_mesh": 150}
SEED = 7


def device_label(device=None) -> str:
    """What ran the rows: the card's name and power limit as nvidia-smi
    gives them (its name alone where nvidia-smi is missing), or the
    device type."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev.type
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)


def write_accuracy_md(rows, out_dir=OUT_DIR, device="cpu"):
    """Write ``rows`` to ``out_dir``/ACCURACY.md (the reference's table)
    and ``out_dir``/ACCURACY.json; ``device`` names what ran them."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "ACCURACY.md")
    lines = [
        "# ACCURACY — production-scale synthetic benchmarks (coslam_torch)",
        "",
        "Long sequences at production shape (640x480, 1024 features/cam),",
        "rendered scenes matching the BASELINE configs (room + forward/yaw",
        "trajectory; dynamic quad for config 3; separation/rejoin for",
        "config 4; radial distortion for the distorted variant). ATE is",
        "Sim(3)-aligned RMSE of camera centers over ALL frames (the",
        "exported, chain-corrected trajectory; occlusion from 20 frames",
        "after uncover). Room size = 10 units; ATE% is relative to the",
        "camera-0 path length. fps ends in a device sync.",
        "",
        f"Last run: {time.strftime('%Y-%m-%d %H:%M')} on `{device}`.",
        "",
        "| config | cams | frames | ATE per cam | max ATE | % of path |"
        " path | fps (e2e) | merges | loops | keyframes |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['config']} | {r['cams']} | {r['frames']} | "
            f"{r['ate']} | {r['ate_max']} | {r['ate_pct_path']}% | "
            f"{r['path_len']} | {r['fps']} | {r['n_merges']} | "
            f"{r['n_loops']} | {r['n_keyframes']} |")
    lines += [
        "",
        "Reproduce: `python -m coslam_torch.examples.accuracy_bench "
        "[config ...]`.",
        "Raw rows (with peak device memory and kernel launches) in "
        "`ACCURACY.json`.",
        "",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    with open(os.path.join(out_dir, "ACCURACY.json"), "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {os.path.abspath(path)}", flush=True)


def merged(rows, out_dir=OUT_DIR):
    """``rows`` merged over the rows already in ``out_dir``/ACCURACY.json,
    in CONFIGS order."""
    path = os.path.join(out_dir, "ACCURACY.json")
    old = {}
    if os.path.exists(path):
        with open(path) as f:
            old = {r["config"]: r for r in json.load(f)}
    for r in rows:
        old[r["config"]] = r
    return [old[k] for k in CONFIGS if k in old]


def main(argv=None):
    """Run the named configs (default: all but fivecam_mesh) from seed 7
    each. Returns the new rows."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="*", default=[])
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--small", action="store_true",
                    help="short sanity run (60 frames)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    unknown = sorted(set(args.configs) - set(CONFIGS))
    if unknown:
        ap.error(f"unknown configs {unknown}; choose from {list(CONFIGS)}")
    device = "cpu" if args.cpu else None
    label = device_label(device)         # raises without a card
    # fivecam_mesh runs only when named, as in the reference's sweep
    names = args.configs or [n for n in CONFIGS if n != "fivecam_mesh"]
    rows = []
    for name in names:
        F = args.frames or (60 if args.small else DEFAULT_FRAMES[name])
        rng = np.random.default_rng(SEED)
        print(f"== {name} ({F} frames) on {label}", flush=True)
        rows.append(CONFIGS[name](F, rng, device=device))
        # write after every config: an interrupted run still leaves the
        # rows of the configs it finished
        write_accuracy_md(merged(rows, args.out), args.out, label)
    if args.small:
        print(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
