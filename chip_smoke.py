"""Chip smoke test of coslam_torch on one CUDA card.

Builds the CUDA kernels from coslam_torch/csrc (build_pyramid, klt_track,
extract_windows), holds each against its plain PyTorch twin at both main
paths' shapes (one camera, and three cameras) and times both (on frames
rendered on the card, held against the same frames rendered on the
CPU), then drives
the engine end to end on two paths at the production configuration
(480x640, 4 KLT levels, 1024 features per camera, 8192 map points, 64
keyframes, BA window 5), each over 100 rendered frames of the synthetic
room:
- monocular: bootstrap, keyframes, BA, finiteness, the Sim(3)-aligned ATE;
- threecam_dyn (three cameras on a rig, a moving textured quad): the
  wide-baseline bootstrap at frame 0, keyframes, BA, every camera's ATE,
  dynamic points, inter-camera mapping and the camera groups;
and checks that every kernel ran on each path (launch counts set to 0
just before a path and read just after it).

Before each path, a short run at the CPU tests' size holds the engine on
the card against the same engine on the CPU (the plain PyTorch versions,
which tests/test_torch_*.py hold against the JAX package): one camera
over 30 frames, two cameras over 20.

After each path, torch.profiler traces a few tracked frames of a fresh
run of it: device-busy time, the device's idle share and kernel launches
per frame, in all and inside the ``build_pyramid`` and ``klt_track``
ranges; ``--profile-table PATH`` also writes the operator tables to PATH
(the second path's beside it, with a ``.threecam`` suffix).

    python3 chip_smoke.py [--profile-table PATH]

Exits non-zero on any failure (and without a CUDA device). The line before
the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

H, W = 480, 640
FRAMES = 100
N_FEAT = 1024
KPROD = np.array([[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1]],
                 np.float32)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
# klt_track against its plain twin (the bands of tests/test_torch_ops.py::
# test_klt_tracked_positions): the 121-term sums are taken in another
# order, which moves positions by float32 rounding and can flip a
# feature that sits on a threshold (0.1 px convergence, search range, SSD)
KLT_FLIP_SHARE = 0.005           # of the features valid on input
KLT_POS_TOL, KLT_GAIN_TOL = 1e-3, 1e-4
KLT_SSD_RTOL, KLT_SSD_ATOL = 1e-3, 1e-2
# the renderer on the card against the CPU, on float16 frames: two float16
# steps at 255 (the ray-plane arithmetic rounds otherwise), outside a share
# of pixels whose ray grazes a seam between two planes and may land on either
RENDER_TOL, RENDER_SHARE = 0.25, 1e-3


def log(msg=""):
    print(msg, flush=True)


def device_time_ms(fn, reps: int = 20, trials: int = 25) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a
    CUDA graph, the graph replayed ``trials`` times between CUDA events;
    the median per-call time. (Eager timing of a microsecond kernel would
    measure the host's launch path, not the card.)"""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return float(np.median(times))


def eager_time_ms(fn, reps: int = 5, trials: int = 5) -> float:
    """Device time of one call of ``fn`` run eagerly: CUDA events around
    ``reps`` calls, the median over ``trials``. For code that cannot be
    captured in a CUDA graph (the plain KLT builds small host tensors);
    it includes the gaps the host's launch path leaves between kernels."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return float(np.median(times))


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false")
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} (count {count}); torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    return name, count, smi


def phase_build():
    from coslam_torch.ops import cuda_lib
    t0 = time.perf_counter()
    info = cuda_lib.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s wall into "
        f"{cuda_lib.build_dir()}")
    for name, rec in info.items():
        log(f"  {name}: nvcc {rec['seconds']:.2f} s")
        for line in rec["ptxas"].splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"    {line.strip()}")


def covered_pixels(h: int, w: int, C: int, base, G: int, dev) -> int:
    """Distinct pixels of a [C, h, w] image that G x G windows at the
    origins base [C, N, 2] (clamped, as every window kernel does) cover."""
    cover = torch.zeros((C, h, w), dtype=torch.bool, device=dev)
    x0 = base[..., 0].long().clamp(0, w - G)
    y0 = base[..., 1].long().clamp(0, h - G)
    g = torch.arange(G, device=dev)
    cam = torch.arange(C, device=dev)[:, None, None, None]
    cover[cam, (y0[..., None, None] + g[:, None]),
          (x0[..., None, None] + g[None, :])] = True
    return int(cover.sum())


def klt_work(pyr_prev, pyr_cur, pos, cfg):
    """Bytes and operations one klt_track call needs on these inputs: the
    distinct pixels its template and target windows cover on every kept
    level (the plain twin's level loop, replayed to find each level's
    target origins), the inputs and the outputs; ~17 flop per patch pixel
    per Gauss-Newton iteration this data runs (resample 7, gain 4,
    residual 2, gradient sums 4) and ~31 per patch pixel per level
    (shifted template, gradients, Hessian, final residual)."""
    from coslam_torch.ops.klt import _MARGIN, _kept_levels, _track_level
    r = cfg.window_radius
    S = 2 * r + 1
    G, GT = S + 1 + 2 * _MARGIN, S + 3
    C, N = pos.shape[:2]
    dev = pos.device
    pos_f = pos.reshape(C * N, 2)
    levels = _kept_levels(pyr_cur, cfg)
    q = pos_f * (0.5 ** levels[0])
    g = torch.ones(C * N, device=dev)
    px, n_it, prev = 0, 0, levels[0]
    for li, lv in enumerate(levels):
        if li > 0:
            q = q * (2.0 ** (prev - lv))
        h, w = pyr_cur.imgs[lv].shape[1:]
        pos_t = pos_f * (0.5 ** lv)
        bt = torch.floor(pos_t - r).to(torch.int32) - 1
        b = torch.floor(q - r).to(torch.int32) - _MARGIN
        px += covered_pixels(h, w, C, bt.reshape(C, N, 2), GT, dev)
        px += covered_pixels(h, w, C, b.reshape(C, N, 2), G, dev)
        q, g, _, _, it = _track_level(pyr_prev.imgs[lv], pyr_cur.imgs[lv],
                                      pos_t, q, g, cfg)
        n_it += int(it.sum())
        prev = lv
    # inputs pos (8 B) + valid (1 B); outputs pos, valid, ssd, gain
    nbytes = px * 4 + C * N * (8 + 1) + C * N * (8 + 1 + 4 + 4)
    flops = S * S * (17 * n_it + 31 * len(levels) * C * N)
    return nbytes, flops, n_it


def klt_agreement(got, want, valid_in) -> dict:
    """Flips of `valid` among the features valid on input, and the worst
    differences where both versions keep the feature."""
    gv, wv = got.valid.cpu(), want.valid.cpu()
    vin = valid_in.cpu()
    both = gv & wv
    pos_err = float((got.pos - want.pos).abs().cpu()[both].max())
    gain_err = float((got.gain - want.gain).abs().cpu()[both].max())
    d_ssd = (got.ssd - want.ssd).abs().cpu()[both]
    ssd_lim = KLT_SSD_ATOL + KLT_SSD_RTOL * want.ssd.abs().cpu()[both]
    return dict(flips=int((gv != wv)[vin].sum()), n_valid_in=int(vin.sum()),
                n_both=int(both.sum()), pos_err=pos_err, gain_err=gain_err,
                ssd_excess=float((d_ssd - ssd_lim).max()))


def production_cfg(C: int):
    from coslam_torch.config import CapacityConfig, KLTConfig, SlamConfig
    return SlamConfig(num_cameras=C, image_height=H, image_width=W,
                      klt=KLTConfig(n_levels=4),
                      cap=CapacityConfig(max_features=N_FEAT,
                                         max_map_points=8192,
                                         max_keyframes=64, ba_window=5))


def threecam_scene(n_frames: int, dev):
    """The threecam_dyn scene of examples/accuracy_bench.py
    (config_threecam_dyn and _rig_frames) from seed 0 where that script
    uses 7: three cameras on a rig (baseline 1.0, orbit_trajectory
    forward 0.04) and a 1.6-unit textured quad moving 0.012 a frame along
    x at depth 14. The generator is drawn in the same order (the quad's
    texture, one uniform, the room) and the frames are rounded to float16
    as there. Returns (frames [F, 3, H, W] on ``dev``, Rs_gt [3, F, 3, 3],
    ts_gt [3, F, 3])."""
    from coslam_torch.io.synthetic import (MovingQuad, make_room,
                                           make_texture, render_sequence,
                                           rig_sequence)
    rng = np.random.default_rng(0)
    quad = MovingQuad(center0=np.array([-3.0, 0.5, 14.0], np.float32),
                      velocity=np.array([0.012, 0.0, 0.0], np.float32),
                      eu=np.array([1.6, 0, 0], np.float32),
                      ev=np.array([0, 1.6, 0], np.float32),
                      tex=make_texture(rng))
    rng.uniform()
    planes = make_room(rng, size=10.0)
    Rs, ts = rig_sequence(3, n_frames, baseline=1.0, forward=0.04)
    frames = torch.stack([render_sequence(planes, KPROD, Rs[c], ts[c], H, W,
                                          quads=[quad], device=dev)
                          for c in range(3)], dim=1)
    return frames.half().float(), Rs, ts


def render_agreement(card, cpu, label: str):
    """Frames rendered on the card against the same frames rendered on the
    CPU: finite, and within RENDER_TOL outside a RENDER_SHARE of pixels."""
    diff = (card.cpu() - cpu).abs()
    share = float((diff > RENDER_TOL).float().mean())
    log(f"render {label} card against cpu: max diff {float(diff.max())}, "
        f"share over {RENDER_TOL}: {share}")
    check(f"render {label}", {
        "finite": bool(torch.isfinite(card).all()),
        f"share over {RENDER_TOL} <= {RENDER_SHARE}": share <= RENDER_SHARE})


def pyramid_record(img, n_lv: int, label: str, pyrs: list):
    """build_pyramid against its plain twin, bit for bit on every level,
    dx and dy, then timed. Appends the kernel's pyramid to ``pyrs``."""
    from coslam_torch.ops.pyramid import build_pyramid, build_pyramid_plain
    got, want = build_pyramid(img, n_lv), build_pyramid_plain(img, n_lv)
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(got.imgs + got.dxs + got.dys,
                    want.imgs + want.dxs + want.dys):
        err = max(err, float((a - b).abs().max()))
        if not torch.equal(a, b):
            raise AssertionError(f"build_pyramid {tuple(a.shape)}: not "
                                 f"bit-identical, max abs err {err}")
    pyrs.append(got)
    C = img.shape[0]
    px = [C * (H >> lv) * (W >> lv) for lv in range(n_lv)]
    nbytes = px[0] * 4 * 3 + sum(px) * 4     # input, dx, dy; every level
    flops = sum(p * 18 for p in px) + px[0] * 20 + sum(px[1:]) * 4
    b_ms, b_by = bound_ms(nbytes, flops)
    return dict(shape=label, max_abs_err=err,
                ms=device_time_ms(lambda: build_pyramid(img, n_lv)),
                plain_ms=device_time_ms(
                    lambda: build_pyramid_plain(img, n_lv)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def klt_records(pyr0, pyr1, n_lv: int, label: str):
    """klt_track against its plain twin on the 1024 corners of each camera
    of pyr0, with slots near the border, slots invalid on input and one
    NaN position (camera 0), as the engine's track table holds them; with
    and without gain. Returns the timed record (with gain)."""
    from coslam_torch.config import KLTConfig
    from coslam_torch.ops.corners import detect_corners
    from coslam_torch.ops.klt import klt_track, klt_track_plain
    dev = pyr0.imgs[0].device
    cfg = KLTConfig(n_levels=n_lv)
    det = detect_corners(pyr0.imgs[0], pyr0.dxs[0], pyr0.dys[0], cfg, N_FEAT)
    pos = det.pos.clone()
    valid = det.valid.clone()
    k = torch.arange(N_FEAT, device=dev)
    pos[0, k % 97 == 3] = torch.tensor([1.5, 3.0], device=dev)
    pos[0, k % 97 == 5] = torch.tensor([W - 4.5, H - 9.25], device=dev)
    valid[0, k % 10 == 7] = False
    pos[0, 11] = float("nan")
    valid[0, 11] = False
    rec = None
    for with_gain in (True, False):
        cfg = KLTConfig(n_levels=n_lv, track_with_gain=with_gain)
        got = klt_track(pyr0, pyr1, pos, valid, cfg)
        want = klt_track_plain(pyr0, pyr1, pos, valid, cfg)
        torch.cuda.synchronize()
        agr = klt_agreement(got, want, valid)
        log(f"klt_track {label} gain={with_gain}: {agr}")
        bad = (agr["flips"] > KLT_FLIP_SHARE * agr["n_valid_in"]
               or agr["n_both"] < 0.5 * agr["n_valid_in"]
               or agr["pos_err"] > KLT_POS_TOL
               or agr["gain_err"] > KLT_GAIN_TOL or agr["ssd_excess"] > 0
               or bool(got.valid[0, 11]))
        if bad:
            raise AssertionError(f"klt_track {label} gain={with_gain} "
                                 f"against its plain twin: {agr}")
        if not with_gain:
            continue
        nbytes, flops, n_it = klt_work(pyr0, pyr1, pos, cfg)
        b_ms, b_by = bound_ms(nbytes, flops)
        rec = dict(shape=label, max_abs_err=agr["pos_err"],
                   iterations=n_it,
                   ms=device_time_ms(
                       lambda: klt_track(pyr0, pyr1, pos, valid, cfg)),
                   plain_ms=eager_time_ms(
                       lambda: klt_track_plain(pyr0, pyr1, pos, valid,
                                               cfg)),
                   bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
                   bound_flops=flops, library_ms=None, **agr)
    return rec


def windows_record(C: int, h: int, w: int, G: int, gen):
    """extract_windows on a random [C, h, w] image batch at N_FEAT random
    origins per camera (some clamped): bit for bit against its plain twin,
    then timed with the torch.gather of the same copy."""
    from coslam_torch.ops.patches import (extract_windows,
                                          extract_windows_plain)
    dev = torch.device("cuda")
    imgs = (torch.rand((C, h, w), generator=gen) * 255).to(dev)
    bx = torch.randint(-3, w - G + 4, (C, N_FEAT, 1), generator=gen)
    by = torch.randint(-3, h - G + 4, (C, N_FEAT, 1), generator=gen)
    base = torch.cat([bx, by], -1).to(torch.int32).to(dev)
    got = extract_windows(imgs, base, G)
    ref = extract_windows_plain(imgs, base, G)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"extract_windows G={G} [{C},{h},{w}]: not "
                             f"bit-identical")
    # bytes this data needs: the distinct image pixels the windows cover,
    # the origins, and the output
    nbytes = covered_pixels(h, w, C, base, G, dev) * 4 + \
        base.numel() * 4 + got.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 0.0)
    # one library call computing the same copy: torch.gather on the flat
    # index (the index is made outside the timed call)
    x0 = base[..., 0].long().clamp(0, w - G)
    y0 = base[..., 1].long().clamp(0, h - G)
    g = torch.arange(G, device=dev)
    idx = ((y0[..., None, None] + g[:, None]) * w
           + (x0[..., None, None] + g[None, :])).reshape(C, -1)
    flat = imgs.reshape(C, -1)
    return dict(shape=f"[{C},{h},{w}] G={G} N={N_FEAT}",
                max_abs_err=float((got - ref).abs().max()),
                ms=device_time_ms(lambda: extract_windows(imgs, base, G)),
                plain_ms=device_time_ms(
                    lambda: extract_windows_plain(imgs, base, G)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=device_time_ms(lambda: torch.gather(flat, 1,
                                                               idx)))


def phase_kernels():
    """Each kernel against its plain twin at both main paths' shapes: one
    camera (the rendered room) and three (the threecam_dyn rig). Returns
    {kernel: [records]}; the three-camera record comes first."""
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    n_lv = 4
    res = {"build_pyramid": [], "klt_track": [], "extract_windows": []}
    rig, _, _ = threecam_scene(3, dev)
    render_agreement(rig, threecam_scene(3, "cpu")[0], "threecam_dyn")
    Rs, ts = orbit_trajectory(3, forward=0.04)
    mono = render_sequence(make_room(np.random.default_rng(0), size=10.0),
                           KPROD, Rs, ts, H, W, device=dev)
    for C, f0, f2 in ((3, rig[0], rig[2]), (1, mono[0][None], mono[2][None])):
        label = f"[{C},{H},{W}] {n_lv} levels"
        pyrs = []
        rec = pyramid_record(f0.contiguous(), n_lv, label, pyrs)
        pyramid_record(f2.contiguous(), n_lv, label, pyrs)
        res["build_pyramid"].append(rec)
        log(f"build_pyramid {rec}")
        rec = klt_records(pyrs[0], pyrs[1], n_lv,
                          f"[{C},{H},{W}] N={N_FEAT} {n_lv} levels")
        res["klt_track"].append(rec)
        log(f"klt_track {rec}")
    # extract_windows: G=12 over the three cameras (the fused step's NCC
    # blocks, inter-camera mapping, registration) and over one camera (the
    # map init's per-camera blocks; the monocular step); G=14 and G=24 on
    # each level of one camera (the plain KLT twin's windows)
    shapes = [(3, 0, 12), (1, 0, 12)] + \
        [(1, lv, G) for lv in range(n_lv) for G in (14, 24)]
    for C, lv, G in shapes:
        rec = windows_record(C, H >> lv, W >> lv, G, gen)
        res["extract_windows"].append(rec)
        log(f"extract_windows {rec}")
    return res


def kernel_counters():
    from coslam_torch.ops.klt import klt_track
    from coslam_torch.ops.patches import extract_windows
    from coslam_torch.ops.pyramid import build_pyramid
    return {"build_pyramid": build_pyramid, "klt_track": klt_track,
            "extract_windows": extract_windows}


def run_engine(cfg, K, frames, device):
    """Drive a fresh engine over ``frames`` [F, C, H, W]. Returns (engine,
    per-frame wall ms, ending in a device sync, and the kernel launches
    of this run: the counts are set to 0 just before it)."""
    from coslam_torch.slam.pipeline import CoSlamEngine
    C = cfg.num_cameras
    eng = CoSlamEngine(cfg, K, np.zeros((C, 5), np.float32), device=device)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    frame_ms = []
    for f in range(frames.shape[0]):
        t0 = time.perf_counter()
        eng.process_frame(frames[f].to(device))
        if device == "cuda":
            torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {name: fn.launches for name, fn in counters.items()}
    return eng, np.asarray(frame_ms), launches


def frame_times(eng, frame_ms):
    """(median over all frames, tracked-frame median, tracked-frame p90)."""
    tracked = [s["frame"] for s in eng.stats_log if "med_err" in s]
    trk = frame_ms[tracked] if tracked else frame_ms
    return (float(np.median(frame_ms)), float(np.median(trk)),
            float(np.percentile(trk, 90)))


def check(name: str, checks: dict):
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{name} checks failed: {bad}")


def phase_main_path(card: str):
    """The production mono configuration, end to end on the card."""
    from coslam_torch.io.ate import ate_rmse, camera_centers
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence)
    cfg = production_cfg(1)
    K = KPROD[None]
    planes = make_room(np.random.default_rng(0), size=10.0)
    Rs_gt, ts_gt = orbit_trajectory(FRAMES, forward=0.04)
    t0 = time.perf_counter()
    frames = render_sequence(planes, KPROD, Rs_gt, ts_gt, H, W,
                             device="cuda")[:, None]
    torch.cuda.synchronize()
    log(f"rendered {FRAMES} frames {tuple(frames.shape)} in "
        f"{time.perf_counter() - t0:.2f} s")
    t_run = time.perf_counter()
    eng, frame_ms, launches = run_engine(cfg, K, frames, "cuda")
    Rs, ts = eng.trajectory(0, correct=True)
    run_s = time.perf_counter() - t_run
    ids, xyz, cov = eng.map_points()
    c_gt = camera_centers(Rs_gt, ts_gt)
    path = float(np.linalg.norm(np.diff(c_gt, axis=0), axis=-1).sum())
    ate = ate_rmse(Rs, ts, Rs_gt, ts_gt)
    med, trk, p90 = frame_times(eng, frame_ms)
    log(f"main path: bootstrapped={eng.bootstrapped} keyframes="
        f"{eng.kf_frames} ba_runs={eng.ba_runs} map_points={len(ids)}")
    log(f"main path: ATE {ate:.6f} over a {path:.4f} path "
        f"({100 * ate / path:.4f}%), {len(eng.kf_frames)} keyframes")
    log(f"main path: per-frame ms median {med:.3f} (all {FRAMES}), "
        f"tracked-frame median {trk:.3f}, p90 {p90:.3f}, total "
        f"{run_s:.2f} s; card {card}")
    log(f"main path: kernel launches {launches}")
    check("main path", {
        "bootstrapped": eng.bootstrapped,
        ">=3 keyframes": len(eng.kf_frames) >= 3,
        "BA ran": eng.ba_runs >= 1,
        "finite poses": bool(np.isfinite(Rs).all() and np.isfinite(ts).all()),
        "finite map": bool(len(ids) > 0 and np.isfinite(xyz).all()
                           and np.isfinite(cov).all()),
        "trajectory shape": Rs.shape == (FRAMES, 3, 3)
        and ts.shape == (FRAMES, 3),
        "ATE < 2% of path": ate < 0.02 * path,
        **{f"{name} launched": n > 0 for name, n in launches.items()},
    })
    return launches, (cfg, K, frames)


def phase_multicam_path(card: str):
    """threecam_dyn at the production configuration, end to end on the
    card: the wide-baseline bootstrap at frame 0, keyframes and BA,
    finite poses and map, every camera's ATE under 2% of camera 0's path,
    dynamic points on the last tracked frame, inter-camera points, and all
    three kernels launched. 100 frames: no group merge is attempted (the
    reference's merge check needs a split, loop closure starts at 120)."""
    from coslam_torch.io.ate import ate_rmse, camera_centers
    t0 = time.perf_counter()
    frames, Rs_gt, ts_gt = threecam_scene(FRAMES, "cuda")
    torch.cuda.synchronize()
    log(f"threecam_dyn: rendered {tuple(frames.shape)} in "
        f"{time.perf_counter() - t0:.2f} s")
    cfg = production_cfg(3)
    K = np.repeat(KPROD[None], 3, 0)
    t_run = time.perf_counter()
    eng, frame_ms, launches = run_engine(cfg, K, frames, "cuda")
    trajs = [eng.trajectory(c, correct=True) for c in range(3)]
    run_s = time.perf_counter() - t_run
    ids, xyz, cov = eng.map_points()
    path = float(np.linalg.norm(np.diff(camera_centers(Rs_gt[0], ts_gt[0]),
                                        axis=0), axis=-1).sum())
    ates = [ate_rmse(*trajs[c], Rs_gt[c], ts_gt[c]) for c in range(3)]
    med, trk, p90 = frame_times(eng, frame_ms)
    tracked = [s for s in eng.stats_log if "n_static" in s]
    last = tracked[-1] if tracked else {}
    n_inter = sum(s.get("n_intercam_points", 0) for s in eng.stats_log)
    trans = [(i, g) for i, g in enumerate(eng.group_hist)
             if i and g != eng.group_hist[i - 1]]
    joint = [s["frame"] for s in eng.stats_log if s.get("joint_pose")]
    n_tracked = len(tracked)
    log(f"threecam_dyn: bootstrap {boot_frame(eng)} keyframes {eng.kf_frames} "
        f"ba_runs {eng.ba_runs} map_points {len(ids)}")
    log(f"threecam_dyn: ATE per camera {[round(a, 6) for a in ates]} over "
        f"a {path:.4f} camera-0 path "
        f"({[round(100 * a / path, 4) for a in ates]}%)")
    log(f"threecam_dyn: last tracked frame n_static {last.get('n_static')} "
        f"n_dynamic {last.get('n_dynamic')}; inter-camera points {n_inter}; "
        f"dynamic snapshots {len(eng.dyn_log)}; joint-pose frames {joint}")
    log(f"threecam_dyn: group_hist first {eng.group_hist[0]} last "
        f"{eng.group_hist[-1]}, transitions {trans}")
    log(f"threecam_dyn: per-frame ms median {med:.3f} (all {FRAMES}), "
        f"tracked-frame median {trk:.3f}, p90 {p90:.3f}, total "
        f"{run_s:.2f} s; card {card}")
    log(f"threecam_dyn: kernel launches {launches}, per tracked frame "
        f"{ {k: round(v / max(n_tracked, 1), 3) for k, v in launches.items()} }")
    check("threecam_dyn", {
        "bootstrap at frame 0": boot_frame(eng) == 0 and eng.kf_frames[0] == 0,
        ">=3 keyframes": len(eng.kf_frames) >= 3,
        "BA ran": eng.ba_runs >= 1,
        "finite poses": all(np.isfinite(R).all() and np.isfinite(t).all()
                            for R, t in trajs),
        "finite map": bool(len(ids) > 0 and np.isfinite(xyz).all()
                           and np.isfinite(cov).all()),
        "every camera's ATE < 2% of the camera-0 path":
            max(ates) < 0.02 * path,
        "n_dynamic >= 1 on the last tracked frame":
            last.get("n_dynamic", 0) >= 1,
        "inter-camera points": n_inter > 0,
        **{f"{name} launched": n > 0 for name, n in launches.items()},
    })
    return launches, (cfg, K, frames)


def boot_frame(eng):
    """The frame at which the engine's bootstrap succeeded (None if
    never)."""
    return next((s["frame"] for s in eng.stats_log if s.get("bootstrap")),
                None)


def agreement(cpu, gpu, Rs_gt, ts_gt, ate_bound: float, label: str):
    """Card against CPU: the same bootstrap frame and group ids, keyframes
    one entry apart at most, each camera's centres after Sim(3) alignment
    within 5% of the path in RMS (10% at worst), and both under the ATE
    bound. The card's float32 solvers, reductions and atomic scatters
    round otherwise than the CPU's, so the runs drift apart from the
    bootstrap on."""
    from coslam_torch.io.ate import ate_rmse, camera_centers, umeyama
    C = cpu.cfg.num_cameras
    checks = {
        "same bootstrap frame": boot_frame(cpu) == boot_frame(gpu) is not None,
        "same group ids": np.array_equal(cpu.group_id, gpu.group_id),
        "keyframes one entry apart": len(set(cpu.kf_frames)
                                         ^ set(gpu.kf_frames)) <= 2,
    }
    log(f"{label}: bootstrap cpu {boot_frame(cpu)} card {boot_frame(gpu)}; "
        f"keyframes cpu {cpu.kf_frames} card {gpu.kf_frames}; groups cpu "
        f"{cpu.group_id.tolist()} card {gpu.group_id.tolist()}")
    for c in range(C):
        c_cpu = camera_centers(*cpu.trajectory(c, True))
        c_gpu = camera_centers(*gpu.trajectory(c, True))
        s, R, t = umeyama(c_gpu, c_cpu)
        gaps = np.linalg.norm((s * (R @ c_gpu.T)).T + t - c_cpu, axis=-1)
        gap, rms = float(gaps.max()), float(np.sqrt(np.mean(gaps ** 2)))
        path = float(np.linalg.norm(np.diff(c_cpu, axis=0), axis=-1).sum())
        ates = [ate_rmse(*e.trajectory(c, True), Rs_gt[c], ts_gt[c])
                for e in (cpu, gpu)]
        log(f"{label}: camera {c}: centre gap rms {rms:.6f} max {gap:.6f} "
            f"over a {path:.4f} path; ATE cpu {ates[0]:.6f} card "
            f"{ates[1]:.6f}")
        checks[f"camera {c} centres within 5% (rms) / 10% (max) of path"] = \
            rms < 0.05 * path and gap < 0.10 * path
        checks[f"camera {c} ATE < {ate_bound}"] = max(ates) < ate_bound
    check(label, checks)


def phase_small_agreement():
    """The mono engine on the card against the CPU at the CPU tests' size
    (small_test_config(1, 150, 200), 30 frames), under the ATE bound of
    tests/test_pipeline_mono.py."""
    from coslam_torch.config import small_test_config
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence)
    h, w, n = 150, 200, 30
    K = np.array([[[180.0, 0, 100], [0, 180.0, 75], [0, 0, 1]]], np.float32)
    Rs_gt, ts_gt = orbit_trajectory(n, forward=0.06)
    frames = render_sequence(make_room(np.random.default_rng(0), size=10.0),
                             K[0], Rs_gt, ts_gt, h, w, device="cpu")[:, None]
    cfg = small_test_config(1, h, w)
    cpu, _, _ = run_engine(cfg, K, frames, "cpu")
    gpu, _, _ = run_engine(cfg, K, frames, "cuda")
    agreement(cpu, gpu, Rs_gt[None], ts_gt[None], 0.20, "small input")


def phase_multicam_small_agreement():
    """The two-camera engine on the card against the CPU on the 20-frame
    rig of tests/test_pipeline_multicam.py (small_test_config(2, 150, 200),
    baseline 1.0, forward 0.06), under that file's ATE bound (0.25); both
    bootstrap at frame 0."""
    from coslam_torch.config import small_test_config
    from coslam_torch.io.synthetic import (make_room, render_sequence,
                                           rig_sequence)
    h, w, n, C = 150, 200, 20, 2
    K1 = np.array([[180.0, 0, 100], [0, 180.0, 75], [0, 0, 1]], np.float32)
    planes = make_room(np.random.default_rng(0), size=10.0)
    Rs_gt, ts_gt = rig_sequence(C, n, baseline=1.0, forward=0.06)
    frames = torch.stack([render_sequence(planes, K1, Rs_gt[c], ts_gt[c], h,
                                          w, device="cpu")
                          for c in range(C)], dim=1)
    cfg = small_test_config(C, h, w)
    K = np.repeat(K1[None], C, 0)
    cpu, _, _ = run_engine(cfg, K, frames, "cpu")
    gpu, _, launched = run_engine(cfg, K, frames, "cuda")
    agreement(cpu, gpu, Rs_gt, ts_gt, 0.25, "two-camera small input")
    check("two-camera small input", {
        "bootstrap at frame 0": boot_frame(cpu) == boot_frame(gpu) == 0,
        **{f"{k} launched": v > 0 for k, v in launched.items()}})


def phase_profile(cfg, K, frames, card: str, table_path, warm: int,
                  label: str):
    """torch.profiler over tracked frames of a fresh run: wall and
    device-busy time per frame, the device's idle share, kernel launches
    per frame, and (to ``table_path``, when given) the table of operators
    by device time."""
    from torch.profiler import ProfilerActivity, profile
    from coslam_torch.slam.pipeline import CoSlamEngine
    n = 5
    C = cfg.num_cameras
    eng = CoSlamEngine(cfg, K, np.zeros((C, 5), np.float32), device="cuda")
    for f in range(warm):
        eng.process_frame(frames[f])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in range(warm, warm + n):
            eng.process_frame(frames[f])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    busy_us, launches = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += e.self_device_time_total
            launches += e.count
    busy_ms = busy_us / 1e3 / n

    # launches inside a range: the CUDA runtime calls (cudaLaunchKernel,
    # cudaLaunchCooperativeKernel, cudaMemcpyAsync, ...) nested in it on the
    # host, and the device activities they started, matched by CUPTI
    # correlation id (the kernels of a ctypes library are attached to no
    # operator, so the range's own device time does not see them)
    events = prof.events()
    on_device = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            on_device.setdefault(e.id, []).append(e)

    def runtime_calls(e):
        out = [e] if e.name.startswith("cu") else []
        for ch in e.cpu_children:
            out += runtime_calls(ch)
        return out
    ranges = {}
    for name in ("build_pyramid", "klt_track"):
        evs = [e for e in events if e.name == name
               and e.device_type == torch.autograd.DeviceType.CPU]
        acts = [a for e in evs for rt in runtime_calls(e)
                for a in on_device.get(rt.id, [])]
        ranges[name] = dict(
            calls_per_frame=len(evs) / n,
            launches_per_frame=len(acts) / n,
            device_ms_per_frame=sum(a.time_range.elapsed_us()
                                    for a in acts) / 1e3 / n,
            kernels=sorted({a.name[:60] for a in acts}))

    if table_path:
        os.makedirs(os.path.dirname(os.path.abspath(table_path)),
                    exist_ok=True)
        with open(table_path, "w") as fh:
            fh.write(f"card: {card}; frames {warm}..{warm + n - 1} of the "
                     f"production {label} config\n")
            fh.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=60))
            fh.write("\n")
            fh.write(prof.key_averages().table(
                sort_by="self_cpu_time_total", row_limit=40))
    log(f"profile {label}: {n} tracked frames ({warm}..{warm + n - 1}), wall "
        f"{wall_ms:.3f} ms/frame, device busy {busy_ms:.3f} ms/frame, idle "
        f"share {1.0 - busy_ms / wall_ms:.4f}, {launches / n:.1f} kernel "
        f"launches/frame; card {card}")
    for name, rec in ranges.items():
        log(f"profile {label}: inside {name}: {rec}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile-table", default=None,
                    help="write the profiler's operator tables here")
    args = ap.parse_args()
    name, count, smi = phase_device()
    phase_build()
    per_shape = phase_kernels()
    phase_small_agreement()
    mono, run = phase_main_path(smi)
    phase_profile(*run, smi, args.profile_table, warm=30, label="mono")
    phase_multicam_small_agreement()
    multi, run = phase_multicam_path(smi)
    phase_profile(*run, smi, args.profile_table and
                  args.profile_table + ".threecam", warm=20,
                  label="threecam_dyn")
    repo = "coslam_tpu"
    meta = {
        "build_pyramid": dict(
            route="cuda", source="coslam_torch/csrc/build_pyramid.cu",
            replaces=f"{repo}/ops/pyramid_pallas.py:107"),
        "klt_track": dict(
            route="cuda", source="coslam_torch/csrc/klt_track.cu",
            replaces=f"{repo}/ops/patches.py:198"),
        "extract_windows": dict(
            route="cuda", source="coslam_torch/csrc/extract_windows.cu",
            replaces=f"{repo}/ops/patches.py:198"),
    }
    kernels = []
    for kname, recs in per_shape.items():
        head = recs[0]          # the three-camera path's shape
        kernels.append(dict(
            name=kname, **meta[kname], launches=mono[kname] + multi[kname],
            launches_by_path={"mono": mono[kname],
                              "threecam_dyn": multi[kname]},
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape=head["shape"]))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
