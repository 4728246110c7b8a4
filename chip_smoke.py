"""Chip smoke test of coslam_torch on one CUDA card.

Builds the CUDA kernels from coslam_torch/csrc (build_pyramid, klt_track,
extract_windows), holds each against its plain PyTorch twin at the main
path's shapes and times both, then drives the monocular engine end to end
at the production configuration (480x640, 4 KLT levels, 1024 features,
8192 map points) over 100 rendered frames of the synthetic room and
checks bootstrap, keyframes, BA, finiteness, the Sim(3)-aligned ATE, and
that every kernel ran on that path.

Before the main path, a short run at the CPU tests' size holds the
engine on the card against the same engine on the CPU (the plain
PyTorch versions, which tests/test_torch_*.py hold against the JAX
package).

After it, torch.profiler traces a few tracked frames of a fresh run at
the same configuration: device-busy time, the device's idle share and
kernel launches per frame, in all and inside the ``build_pyramid`` and
``klt_track`` ranges; ``--profile-table PATH`` also writes the operator
table to PATH.

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
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
# klt_track against its plain twin (the bands of tests/test_torch_ops.py::
# test_klt_tracked_positions): the 121-term sums are taken in another
# order, which moves positions by float32 rounding and can flip a
# feature that sits on a threshold (0.1 px convergence, search range, SSD)
KLT_FLIP_SHARE = 0.005           # of the features valid on input
KLT_POS_TOL, KLT_GAIN_TOL = 1e-3, 1e-4
KLT_SSD_RTOL, KLT_SSD_ATOL = 1e-3, 1e-2


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


def phase_kernels():
    """Each kernel against its plain twin at the main path's shapes."""
    from coslam_torch.config import KLTConfig
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence)
    from coslam_torch.ops.corners import detect_corners
    from coslam_torch.ops.klt import klt_track, klt_track_plain
    from coslam_torch.ops.patches import (extract_windows,
                                          extract_windows_plain)
    from coslam_torch.ops.pyramid import build_pyramid, build_pyramid_plain
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    n_lv = 4
    levels = [(H >> lv, W >> lv) for lv in range(n_lv)]
    res = {"build_pyramid": [], "klt_track": [], "extract_windows": []}

    # build_pyramid: every level bit for bit, on two rendered frames
    K = np.array([[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1]],
                 np.float32)
    Rs, ts = orbit_trajectory(3, forward=0.04)
    frames = render_sequence(make_room(np.random.default_rng(0), size=10.0),
                             K, Rs, ts, H, W, device=dev)
    img0, img2 = frames[0][None].contiguous(), frames[2][None].contiguous()
    pyrs, err = [], 0.0
    for img in (img0, img2):
        got, want = build_pyramid(img, n_lv), build_pyramid_plain(img, n_lv)
        torch.cuda.synchronize()
        for a, b in zip(got.imgs + got.dxs + got.dys,
                        want.imgs + want.dxs + want.dys):
            err = max(err, float((a - b).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(
                    f"build_pyramid {tuple(a.shape)}: not bit-identical, max "
                    f"abs err {err}")
        pyrs.append(got)
    px = [h * w for h, w in levels]
    nbytes = px[0] * 4 * 3 + sum(px) * 4     # input, dx, dy; every level
    flops = sum(p * 18 for p in px) + px[0] * 20 + sum(px[1:]) * 4
    b_ms, b_by = bound_ms(nbytes, flops)
    rec = dict(shape=f"[1,{H},{W}] {n_lv} levels", max_abs_err=err,
               ms=device_time_ms(lambda: build_pyramid(img0, n_lv)),
               plain_ms=device_time_ms(
                   lambda: build_pyramid_plain(img0, n_lv)),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    res["build_pyramid"].append(rec)
    log(f"build_pyramid {rec}")

    # klt_track: frame 0 -> frame 2 of the main path's trajectory, the
    # production config's 1024 corners, with slots near the border,
    # slots invalid on input and one NaN position, as the engine's track
    # table holds them
    cfg = KLTConfig(n_levels=n_lv)
    det = detect_corners(pyrs[0].imgs[0], pyrs[0].dxs[0], pyrs[0].dys[0],
                         cfg, N_FEAT)
    pos = det.pos.clone()
    valid = det.valid.clone()
    k = torch.arange(N_FEAT, device=dev)
    pos[0, k % 97 == 3] = torch.tensor([1.5, 3.0], device=dev)
    pos[0, k % 97 == 5] = torch.tensor([W - 4.5, H - 9.25], device=dev)
    valid[0, k % 10 == 7] = False
    pos[0, 11] = float("nan")
    valid[0, 11] = False
    for with_gain in (True, False):
        cfg = KLTConfig(n_levels=n_lv, track_with_gain=with_gain)
        got = klt_track(pyrs[0], pyrs[1], pos, valid, cfg)
        want = klt_track_plain(pyrs[0], pyrs[1], pos, valid, cfg)
        torch.cuda.synchronize()
        agr = klt_agreement(got, want, valid)
        log(f"klt_track gain={with_gain}: {agr}")
        bad = (agr["flips"] > KLT_FLIP_SHARE * agr["n_valid_in"]
               or agr["n_both"] < 0.5 * agr["n_valid_in"]
               or agr["pos_err"] > KLT_POS_TOL
               or agr["gain_err"] > KLT_GAIN_TOL or agr["ssd_excess"] > 0
               or bool(got.valid[0, 11]))
        if bad:
            raise AssertionError(f"klt_track gain={with_gain} against its "
                                 f"plain twin: {agr}")
        if not with_gain:
            continue
        nbytes, flops, n_it = klt_work(pyrs[0], pyrs[1], pos, cfg)
        b_ms, b_by = bound_ms(nbytes, flops)
        rec = dict(shape=f"[1,{H},{W}] N={N_FEAT} {n_lv} levels",
                   max_abs_err=agr["pos_err"], iterations=n_it,
                   ms=device_time_ms(
                       lambda: klt_track(pyrs[0], pyrs[1], pos, valid, cfg)),
                   plain_ms=eager_time_ms(
                       lambda: klt_track_plain(pyrs[0], pyrs[1], pos, valid,
                                               cfg)),
                   bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
                   bound_flops=flops, library_ms=None, **agr)
        res["klt_track"].append(rec)
        log(f"klt_track {rec}")

    # extract_windows: G=14 and G=24 on each level (the plain KLT), G=12
    # on level 0 (NCC, the kernel's one call per tracked frame)
    shapes = [(lv, G) for lv in range(4) for G in (14, 24)] + [(0, 12)]
    for lv, G in shapes:
        h, w = levels[lv]
        imgs = (torch.rand((1, h, w), generator=gen) * 255).to(dev)
        bx = torch.randint(-3, w - G + 4, (1, N_FEAT, 1), generator=gen)
        by = torch.randint(-3, h - G + 4, (1, N_FEAT, 1), generator=gen)
        base = torch.cat([bx, by], -1).to(torch.int32).to(dev)
        got = extract_windows(imgs, base, G)
        ref = extract_windows_plain(imgs, base, G)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"extract_windows G={G} {h}x{w}: not "
                                 f"bit-identical")
        err = float((got - ref).abs().max())
        # bytes this data needs: the distinct image pixels the windows
        # cover, the origins, and the output
        nbytes = covered_pixels(h, w, 1, base, G, dev) * 4 + \
            base.numel() * 4 + got.numel() * 4
        b_ms, b_by = bound_ms(nbytes, 0.0)
        ms = device_time_ms(lambda: extract_windows(imgs, base, G))
        plain_ms = device_time_ms(
            lambda: extract_windows_plain(imgs, base, G))
        # one library call computing the same copy: torch.gather on the
        # flat index (index precomputed outside the timed call)
        x0 = base[0, :, 0].long().clamp(0, w - G)
        y0 = base[0, :, 1].long().clamp(0, h - G)
        g = torch.arange(G, device=dev)
        idx = ((y0[:, None, None] + g[None, :, None]) * w
               + (x0[:, None, None] + g[None, None, :])).reshape(1, -1)
        flat = imgs.reshape(1, -1)
        lib_ms = device_time_ms(lambda: torch.gather(flat, 1, idx))
        rec = dict(shape=f"[1,{h},{w}] G={G} N={N_FEAT}", max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib_ms)
        res["extract_windows"].append(rec)
        log(f"K2 extract_windows {rec}")
    return res


def phase_main_path(card: str):
    """The production mono configuration, end to end on the card."""
    from coslam_torch.config import CapacityConfig, KLTConfig, SlamConfig
    from coslam_torch.io.ate import ate_rmse, camera_centers
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence)
    from coslam_torch.ops.klt import klt_track
    from coslam_torch.ops.patches import extract_windows
    from coslam_torch.ops.pyramid import build_pyramid
    from coslam_torch.slam.pipeline import CoSlamEngine

    counters = {"build_pyramid": build_pyramid, "klt_track": klt_track,
                "extract_windows": extract_windows}
    cfg = SlamConfig(num_cameras=1, image_height=H, image_width=W,
                     klt=KLTConfig(n_levels=4),
                     cap=CapacityConfig(max_features=N_FEAT,
                                        max_map_points=8192,
                                        max_keyframes=64, ba_window=5))
    K = np.array([[[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1]]],
                 np.float32)
    kc = np.zeros((1, 5), np.float32)
    rng = np.random.default_rng(0)
    planes = make_room(rng, size=10.0)
    Rs_gt, ts_gt = orbit_trajectory(FRAMES, forward=0.04)
    t0 = time.perf_counter()
    frames = render_sequence(planes, K[0], Rs_gt, ts_gt, H, W, device="cuda")
    torch.cuda.synchronize()
    log(f"rendered {FRAMES} frames {tuple(frames.shape)} in "
        f"{time.perf_counter() - t0:.2f} s")
    eng = CoSlamEngine(cfg, K, kc, device="cuda")
    for fn in counters.values():
        fn.launches = 0
    frame_ms = []
    t_run = time.perf_counter()
    for f in range(FRAMES):
        t0 = time.perf_counter()
        eng.process_frame(frames[f][None])
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    Rs, ts = eng.trajectory(0, correct=True)
    run_s = time.perf_counter() - t_run
    launches = {name: fn.launches for name, fn in counters.items()}
    ids, xyz, cov = eng.map_points()
    c_gt = camera_centers(Rs_gt, ts_gt)
    path = float(np.linalg.norm(np.diff(c_gt, axis=0), axis=-1).sum())
    ate = ate_rmse(Rs, ts, Rs_gt, ts_gt)
    tracked = [s["frame"] for s in eng.stats_log if "med_err" in s]
    fm = np.asarray(frame_ms)
    trk = fm[tracked] if tracked else fm
    log(f"main path: bootstrapped={eng.bootstrapped} keyframes="
        f"{eng.kf_frames} ba_runs={eng.ba_runs} map_points={len(ids)}")
    log(f"main path: ATE {ate:.6f} over a {path:.4f} path "
        f"({100 * ate / path:.4f}%), {len(eng.kf_frames)} keyframes")
    log(f"main path: per-frame ms median {np.median(fm):.3f} (all "
        f"{FRAMES}), tracked-frame median {np.median(trk):.3f}, p90 "
        f"{np.percentile(trk, 90):.3f}, total {run_s:.2f} s; card {card}")
    log(f"main path: kernel launches {launches}")
    checks = {
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
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"main path checks failed: {bad}")
    return launches, (cfg, K, frames)


def _mono_engine_run(cfg, K, frames, device):
    from coslam_torch.slam.pipeline import CoSlamEngine
    eng = CoSlamEngine(cfg, K, np.zeros((1, 5), np.float32), device=device)
    for f in range(frames.shape[0]):
        eng.process_frame(frames[f][None].to(device))
    return eng


def phase_small_agreement():
    """The engine on the card against the same engine on the CPU, at the
    CPU tests' size (small_test_config(1, 150, 200), 30 frames): the same
    bootstrap frame, keyframes one entry apart at most, camera centres
    after Sim(3) alignment within 5% of the path in RMS and 10% at worst
    (the card's float32 solvers, reductions and atomic scatters round
    otherwise than the CPU's, and the runs drift apart from the bootstrap
    on), and both under the ATE bound of tests/test_pipeline_mono.py."""
    from coslam_torch.config import small_test_config
    from coslam_torch.io.ate import ate_rmse, camera_centers, umeyama
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence)
    h, w, n = 150, 200, 30
    K = np.array([[[180.0, 0, 100], [0, 180.0, 75], [0, 0, 1]]], np.float32)
    Rs_gt, ts_gt = orbit_trajectory(n, forward=0.06)
    frames = render_sequence(make_room(np.random.default_rng(0), size=10.0),
                             K[0], Rs_gt, ts_gt, h, w, device="cpu")
    cfg = small_test_config(1, h, w)
    cpu = _mono_engine_run(cfg, K, frames, "cpu")
    gpu = _mono_engine_run(cfg, K, frames, "cuda")
    c_cpu = camera_centers(*cpu.trajectory(0, True))
    c_gpu = camera_centers(*gpu.trajectory(0, True))
    s, R, t = umeyama(c_gpu, c_cpu)
    gaps = np.linalg.norm((s * (R @ c_gpu.T)).T + t - c_cpu, axis=-1)
    gap, rms = float(gaps.max()), float(np.sqrt(np.mean(gaps ** 2)))
    path = float(np.linalg.norm(np.diff(c_cpu, axis=0), axis=-1).sum())
    ates = [ate_rmse(*e.trajectory(0, True), Rs_gt, ts_gt)
            for e in (cpu, gpu)]

    def boot(e):
        return next((s["frame"] for s in e.stats_log if s.get("bootstrap")),
                    None)
    log(f"small input: bootstrap cpu {boot(cpu)} card {boot(gpu)}; "
        f"keyframes cpu {cpu.kf_frames} card {gpu.kf_frames}; centre gap "
        f"rms {rms:.6f} max {gap:.6f} over a {path:.4f} path; ATE cpu "
        f"{ates[0]:.6f} card {ates[1]:.6f}")
    checks = {
        "same bootstrap frame": boot(cpu) == boot(gpu) is not None,
        "keyframes one entry apart": len(set(cpu.kf_frames)
                                         ^ set(gpu.kf_frames)) <= 2,
        "centres within 5% (rms) / 10% (max) of path":
            rms < 0.05 * path and gap < 0.10 * path,
        "ATE < 0.20": max(ates) < 0.20,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"small-input agreement failed: {bad}")


def phase_profile(cfg, K, frames, card: str, table_path):
    """torch.profiler over tracked frames of a fresh production-config
    run: wall and device-busy time per frame, the device's idle share,
    kernel launches per frame, and (to ``table_path``, when given) the
    table of operators by device time."""
    from torch.profiler import ProfilerActivity, profile
    from coslam_torch.slam.pipeline import CoSlamEngine
    warm, n = 30, 5
    eng = CoSlamEngine(cfg, K, np.zeros((1, 5), np.float32), device="cuda")
    for f in range(warm):
        eng.process_frame(frames[f][None])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in range(warm, warm + n):
            eng.process_frame(frames[f][None])
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
                     f"production mono config\n")
            fh.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=60))
            fh.write("\n")
            fh.write(prof.key_averages().table(
                sort_by="self_cpu_time_total", row_limit=40))
    log(f"profile: {n} tracked frames, wall {wall_ms:.3f} ms/frame, device "
        f"busy {busy_ms:.3f} ms/frame, idle share "
        f"{1.0 - busy_ms / wall_ms:.4f}, {launches / n:.1f} kernel "
        f"launches/frame; card {card}")
    for name, rec in ranges.items():
        log(f"profile: inside {name}: {rec}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile-table", default=None,
                    help="write the profiler's operator table here")
    args = ap.parse_args()
    name, count, smi = phase_device()
    phase_build()
    per_shape = phase_kernels()
    phase_small_agreement()
    launches, run = phase_main_path(smi)
    phase_profile(*run, smi, args.profile_table)
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
        head = recs[0] if kname != "extract_windows" else \
            next(r for r in recs if r["shape"].startswith(f"[1,{H},{W}] G=12"))
        kernels.append(dict(
            name=kname, **meta[kname], launches=launches[kname],
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
