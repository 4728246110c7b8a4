"""Chip smoke test of coslam_torch on one CUDA card.

Builds the five CUDA kernels from coslam_torch/csrc (build_pyramid,
klt_track, extract_windows, ncc_blocks, ncc_search), holds each against
its plain PyTorch twin at the paths' shapes (one camera, three cameras,
and the loop closure's G = 43 template search; and the general paths of
klt_track, ncc_blocks and ncc_search at radius 9, search radius 24)
and times both (on frames
rendered on the card, held against the same frames rendered on the CPU;
the two NCC kernels also against their plain versions, the previous NCC
path, in turns, with the device activities of one call of each), then
drives the engine end to end on four paths at the production
configuration (480x640, 4 KLT levels, 1024 features per camera, 8192 map
points, 64 keyframes, BA window 5) in the synthetic room:
- monocular, 100 frames: bootstrap, keyframes, BA, finiteness, the
  Sim(3)-aligned ATE, and the synchronizing calls a tracked frame (none
  inside the tracked step);
- the same 100 frames in the engine modes (chunk=4, overlap, async BA on
  a side stream): every frame posed and logged, ATE, keyframes, BAs
  applied through their events, synchronizing calls;
- threecam_dyn, 100 frames (three cameras on a rig, a moving textured
  quad): the wide-baseline bootstrap at frame 0, keyframes, BA, every
  camera's ATE, dynamic points, inter-camera mapping and the groups;
- splitmerge, 400 frames (two cameras; camera 1 yaws away and back): the
  groups split, the merge bridge rejoins them, every camera's ATE;
- mono_loop, 400 frames (one camera maps a wall, turns away and comes
  back): a loop closure anchored on the dormant map, the ATE;
- distorted_io, 100 frames of the reference's distorted configuration
  (three cameras on a rig, k1 = -0.25, k2 = 0.08) read from files: CSRW
  videos, calibration files and an input.txt through the CLI
  (``coslam_torch.cli``, the native loader, the export), every camera's
  ATE from the exported poses; a checkpoint at frame 60 resumed against
  the uninterrupted run to frame 80; the loader alone, loader-fed
  against 20 resident frames, the feature log's synchronizing calls,
  checkpoint save and load; TV-L1 flow on a pair of its frames, card
  against CPU;
- fivecam_mesh, 60 of the reference's 150 frames (five cameras on a
  rig, BASELINE config 5): the chunked engine (chunk=6) on a camera mesh,
  one camera a shard over the visible cards round robin (["cuda:0"] * 5
  on one card), the frames copied from the host to their shards: the
  bootstrap by frame 2, one group, every camera's ATE, the kernels once a
  shard, each mesh step's transfers exactly the step contract (each
  shard's 11 track rows there and back, its NCC block pair back), no
  synchronizing call inside the step;
- accuracy_harness: the port's accuracy harness
  (``coslam_torch.examples.accuracy_bench``) in-process on its full
  300-frame ``occlusion`` config (two cameras, camera 1's lens covered
  over frames 75-135, seed 7, chunk=6, the frames staged as float16):
  every row key present and finite, camera 1 split off during the
  blackout, a realigning merge after uncover, one group at the end, the
  ATE from 20 frames after uncover; then ``run_synthetic`` on the card
  and ``visualize_results`` on an export of the occlusion run;
- timing_tools: the four timing tools (``coslam_torch.examples.
  profile_stages``, ``profile_ablate``, ``profile_ba``,
  ``profile_engine``) through their ``main`` at the bench shapes (3
  cameras at 480x640; the BA at 15 cameras x 2048 points), logging every
  number they return: all finite, the stage tool's pyramid, KLT and
  new-points stages launching build_pyramid, klt_track and ncc_blocks
  each call, and no tool on a plain version;
and checks that the path's kernels ran (launch counts set to 0 just
before a path and read just after it): build_pyramid, klt_track and
ncc_blocks on every path, ncc_search once per searching closure attempt
on mono_loop, and extract_windows on none (it serves the plain versions
only). Every engine path logs the peak device memory of each card, and
the mono, modes and fivecam_mesh paths the synchronizing calls and, apart,
the package's explicit torch.cuda.synchronize calls.

The multi-device layer also gets: the two-camera engine on a mesh
against the same engine on one card (20 frames at 150x200); run_dryrun(5)
at 480x640; the distributed table BA over 5 point shards against the
one-card solve on bench.py's BA problem, both timed as LM iterations/s;
and async BA solved on another device (cuda:1, else the CPU) over the
mono scene.

Short runs at the CPU tests' size hold the engine on the card against the
same engine on the CPU (the plain PyTorch versions, which
tests/test_torch_*.py hold against the JAX package): one camera over 30
frames (and the non-fused path over the same 30), two cameras over 20,
and mono_loop cut to 150x200 over 181 frames (a loop closure). The CPU
runs are made by one worker process while the card's phases run.

torch.profiler traces 3 tracked frames of mono (30-32) and threecam_dyn
(20-22), and of splitmerge around its first merge, each replayed from a
copy of its path's engine taken before the first of them: device-busy
time, the device's idle share and kernel launches per frame, in all and
inside the ``build_pyramid``, ``klt_track`` and ``ncc_blocks`` ranges
(read from the profiler's raw events; the operator tables only with
``--profile-table``);
``--profile-table PATH`` also writes the operator tables to PATH (the
others beside it, with a ``.threecam`` and ``.splitmerge`` suffix).

    python3 chip_smoke.py [--profile-table PATH]
    python3 chip_smoke.py --syncs-only   # the sync count alone

Each phase's wall time is logged.

Exits non-zero on any failure (and without a CUDA device). The line before
the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ProcessPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

H, W = 480, 640
FRAMES = 100
LONG_FRAMES = 400                # splitmerge and mono_loop
N_FEAT = 1024
N_LOOP = 256                     # dormant points one closure searches
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


def activities_per_call(fn, calls: int = 10):
    """Device activities (kernels, copies, sets) one call of ``fn`` starts,
    counted under torch.profiler over ``calls`` calls, and their names.
    The device-side marks of the wrappers' record_function ranges are not
    activities and are left out."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    acts = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in kernel_counters()]
    return len(acts) / calls, sorted({a[:48] for a in acts})


def activity_counts(kernel, plain) -> dict:
    """Device activities per call of a kernel's wrapper and of its plain
    version, with the names of the wrapper's."""
    n, names = activities_per_call(kernel)
    return dict(activities=n, activity_names=names,
                plain_activities=activities_per_call(plain)[0])


def in_turns(kernel, plain) -> dict:
    """Eager device time of one call (CUDA events around 20 calls, median
    of 5) of the kernel's wrapper and of its plain version, in turns:
    plain, kernel, kernel, plain. (Timed eagerly, as the engine calls
    them: it includes the gaps the host's launch path leaves between the
    plain versions' ~30-45 kernels.)"""
    t = [eager_time_ms(f, reps=20) for f in (plain, kernel, kernel, plain)]
    return dict(eager_ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2,
                turns_ms=t)


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


def klt_records(pyr0, pyr1, n_lv: int, label: str, radius: int = 5):
    """klt_track against its plain twin on the 1024 corners of each camera
    of pyr0, with slots near the border, slots invalid on input and one
    NaN position (camera 0), as the engine's track table holds them; with
    and without gain, at window radius ``radius`` (above 7: the kernel's
    general path). Returns the timed record (with gain)."""
    from coslam_torch.config import KLTConfig
    from coslam_torch.ops.corners import detect_corners
    from coslam_torch.ops.klt import klt_track, klt_track_plain
    dev = pyr0.imgs[0].device
    cfg = KLTConfig(n_levels=n_lv, window_radius=radius)
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
        cfg = KLTConfig(n_levels=n_lv, track_with_gain=with_gain,
                        window_radius=radius)
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


def windows_record(C: int, h: int, w: int, G: int, gen, n: int = N_FEAT):
    """extract_windows on a random [C, h, w] image batch at ``n`` random
    origins per camera (some clamped): bit for bit against its plain twin,
    then timed with the torch.gather of the same copy."""
    from coslam_torch.ops.patches import (extract_windows,
                                          extract_windows_plain)
    dev = torch.device("cuda")
    imgs = (torch.rand((C, h, w), generator=gen) * 255).to(dev)
    bx = torch.randint(-3, w - G + 4, (C, n, 1), generator=gen)
    by = torch.randint(-3, h - G + 4, (C, n, 1), generator=gen)
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
    return dict(shape=f"[{C},{h},{w}] G={G} N={n}",
                max_abs_err=float((got - ref).abs().max()),
                ms=device_time_ms(lambda: extract_windows(imgs, base, G)),
                plain_ms=device_time_ms(
                    lambda: extract_windows_plain(imgs, base, G)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=device_time_ms(lambda: torch.gather(flat, 1,
                                                               idx)))


def ncc_blocks_record(imgs, gen, radius: int = 5, n: int = N_FEAT):
    """ncc_blocks on rendered frames [C, H, W] with a textureless strip, at
    ``n`` random positions per camera over and past the image: within 1e-5
    of its plain version on the card (the previous path) with identical
    flags, then timed against it."""
    from coslam_torch.ops.ncc import (extract_ncc_blocks_batched,
                                      extract_ncc_blocks_batched_plain)
    dev = imgs.device
    C, h, w = imgs.shape
    imgs = imgs.clone()
    imgs[:, :, 300:340] = 7.0
    pos = (torch.rand((C, n, 2), generator=gen)
           * torch.tensor([w + 12.0, h + 12.0]) - 6.0).to(dev)
    got = extract_ncc_blocks_batched(imgs, pos, radius)
    want = extract_ncc_blocks_batched_plain(imgs, pos, radius)
    torch.cuda.synchronize()
    err = float((got[0] - want[0]).abs().max())
    n_ok = int(want[1].sum())
    check(f"ncc_blocks [{C},{h},{w}]", {
        "blocks within 1e-5": err <= 1e-5,
        "ok identical": torch.equal(got[1], want[1]),
        "some blocks valid and some not": 0 < n_ok < C * n})
    S = 2 * radius + 1
    base = torch.floor(pos - radius).to(torch.int32)
    nbytes = covered_pixels(h, w, C, base, S + 1, dev) * 4 + pos.numel() * 4 \
        + got[0].numel() * 4 + got[1].numel()
    # shift 7, mean 1, centre 1, square and sum 2, divide 1 per pixel
    b_ms, b_by = bound_ms(nbytes, 12.0 * got[0].numel())

    def kernel():
        return extract_ncc_blocks_batched(imgs, pos, radius)

    def plain():
        return extract_ncc_blocks_batched_plain(imgs, pos, radius)
    return dict(shape=f"[{C},{h},{w}] N={n} r={radius}", max_abs_err=err,
                n_valid=n_ok, ms=device_time_ms(kernel), **in_turns(kernel,
                                                                  plain),
                bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
                **activity_counts(kernel, plain), library_ms=None)


def ncc_search_record(img, gen, search_radius: int = 16, n: int = N_LOOP,
                      patch_radius: int = 5):
    """ncc_search as loop closure calls it (radius 16: G = 43, 256 centres
    up to 12 px off the templates' true positions, three so near the
    border that their windows clamp) against its plain version on the
    card (the previous path): the same best pixel on >= 99% of the
    centres, scores within 1e-4, the clamped centres at NCC_INVALID; then
    timed against it, and beside the plain version's grouped convolution
    alone."""
    import torch.nn.functional as F
    from coslam_torch.ops.ncc import (NCC_INVALID, extract_ncc_blocks,
                                      ncc_search, ncc_search_plain)
    from coslam_torch.ops.patches import extract_windows
    dev = img.device
    h, w = img.shape
    r, sr = patch_radius, search_radius
    S, G, K = 2 * r + 1, 2 * (r + sr) + 1, 2 * sr + 1
    # windows clamp only for the first three centres: round(c) - (r + sr)
    # within [0, dim - G - 1] for every centre 12 px or less off a true
    # position (m = 35 at the engine's radii)
    m = r + sr + 14
    true = torch.round(torch.rand((n, 2), generator=gen)
                       * torch.tensor([w - 2.0 * m, h - 2.0 * m]) + m)
    centers = true + torch.randint(-12, 13, (n, 2), generator=gen)
    centers[:3] = torch.tensor([[5.0, h / 2], [w / 2, h - 3.0],
                                [w - 4.0, 10.0]])
    centers, true = centers.to(dev), true.to(dev)
    tmpl, _ = extract_ncc_blocks(img, true, r)
    got = ncc_search(img, centers, tmpl, sr, r)
    want = ncc_search_plain(img, centers, tmpl, sr, r)
    torch.cuda.synchronize()
    same = (got[0] == want[0]).all(1)
    err = float((got[1] - want[1]).abs()[same].max())
    log(f"ncc_search G={G} N={n}: same best pixel as its plain version on "
        f"{float(same.float().mean()):.4f} of the centres, max score diff "
        f"{err}")
    check("ncc_search against its plain version", {
        "same best pixel on >= 99%": float(same.float().mean()) >= 0.99,
        "scores within 1e-4": err <= 1e-4,
        "clamped centres at NCC_INVALID":
            bool((got[1][:3] == NCC_INVALID).all()
                 and (want[1][:3] == NCC_INVALID).all()
                 and (got[1][3:] > NCC_INVALID).all())})
    basec = torch.stack([
        (torch.round(centers[:, 0]) - (r + sr)).clamp(0, w - G - 1),
        (torch.round(centers[:, 1]) - (r + sr)).clamp(0, h - G - 1)],
        -1).to(torch.int32)
    nbytes = covered_pixels(h, w, 1, basec[None], G, dev) * 4 + \
        centers.numel() * 4 + tmpl.numel() * 4 + n * 12
    # the correlation (2 flop per template pixel per offset); the window
    # sums, variance and score (~8 per offset)
    flops = (2.0 * S * S + 8.0) * K * K * n
    b_ms, b_by = bound_ms(nbytes, flops)
    # the plain version's grouped convolution alone, on its windows
    Wn = extract_windows(img[None], basec[None].contiguous(), G)[:, :, 0]
    Wn = Wn.permute(2, 0, 1)[None].contiguous()
    wt = tmpl.reshape(n, 1, S, S)

    def kernel():
        return ncc_search(img, centers, tmpl, sr, r)

    def plain():
        return ncc_search_plain(img, centers, tmpl, sr, r)
    return dict(shape=f"[1,{h},{w}] G={G} N={n}", max_abs_err=err,
                same_best_px=float(same.float().mean()),
                ms=device_time_ms(kernel), **in_turns(kernel, plain),
                bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
                bound_flops=flops, **activity_counts(kernel, plain),
                conv_ms=device_time_ms(lambda: F.conv2d(Wn, wt, groups=n)),
                library_ms=None)


def phase_kernels():
    """Each kernel against its plain twin at both main paths' shapes: one
    camera (the rendered room) and three (the threecam_dyn rig). Returns
    {kernel: [records]}; the three-camera record comes first."""
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence)
    from coslam_torch.ops.pyramid import build_pyramid
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    n_lv = 4
    res = {"build_pyramid": [], "klt_track": [], "extract_windows": [],
           "ncc_blocks": [], "ncc_search": []}
    rig, _, _ = threecam_scene(3, dev)
    render_agreement(rig, threecam_scene(3, "cpu")[0], "threecam_dyn")
    Rs, ts = orbit_trajectory(3, forward=0.04)
    mono = render_sequence(make_room(np.random.default_rng(0), size=10.0),
                           KPROD, Rs, ts, H, W, device=dev)
    for C, f0, f2 in ((3, rig[0], rig[2]), (1, mono[0][None], mono[2][None])):
        rec = ncc_blocks_record(f0.contiguous(), gen)
        res["ncc_blocks"].append(rec)
        log(f"ncc_blocks {rec}")
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
    # extract_windows at the plain versions' shapes: G=12 over three
    # cameras and over one (the plain NCC blocks), G=14 and G=24 on each
    # level of one camera (the plain KLT twin's windows)
    shapes = [(3, 0, 12), (1, 0, 12)] + \
        [(1, lv, G) for lv in range(n_lv) for G in (14, 24)]
    for C, lv, G in shapes:
        rec = windows_record(C, H >> lv, W >> lv, G, gen)
        res["extract_windows"].append(rec)
        log(f"extract_windows {rec}")
    # the plain loop closure search's windows: G = 43 (radius 16), N = 256
    rec = windows_record(1, H, W, 43, gen, n=N_LOOP)
    res["extract_windows"].append(rec)
    log(f"extract_windows {rec}")
    rec = ncc_search_record(mono[0].contiguous(), gen)
    res["ncc_search"].append(rec)
    log(f"ncc_search {rec}")
    check("one device activity a call of each NCC kernel", {
        f"{k} {r['shape']}: {r['activities']} <= 3": r["activities"] <= 3
        for k in ("ncc_blocks", "ncc_search") for r in res[k]})
    ncc_search_agreement(mono[0], gen)
    # the general paths, at radii above the tuned paths' (window and patch
    # radius 9, search radius 24), on one camera, in the same bands
    general = {}
    p0, p2 = (build_pyramid(mono[k][None].contiguous(), n_lv) for k in (0, 2))
    general["klt_track"] = klt_records(
        p0, p2, n_lv, f"[1,{H},{W}] N={N_FEAT} {n_lv} levels r=9", radius=9)
    general["ncc_blocks"] = ncc_blocks_record(mono[0][None].contiguous(),
                                              gen, radius=9)
    general["ncc_search"] = ncc_search_record(mono[0].contiguous(), gen,
                                              search_radius=24,
                                              patch_radius=9)
    for k, rec in general.items():
        log(f"{k} general path {rec}")
    res["general_radius"] = general
    return res


def ncc_search_agreement(img, gen):
    """ncc_search as loop closure calls it (radius 16, 256 centres a few
    px off the templates' true positions) on the card against the CPU:
    the kernel's sums run in another order than the CPU's convolutions, so
    the best pixel agrees on >= 99% of the centres and the scores to
    1e-4."""
    from coslam_torch.ops.ncc import extract_ncc_blocks, ncc_search
    img = img.cpu()
    true = torch.round(torch.rand((N_LOOP, 2), generator=gen)
                       * torch.tensor([W - 60.0, H - 60.0]) + 30.0)
    centers = true + torch.randint(-12, 13, (N_LOOP, 2), generator=gen)
    tmpl, _ = extract_ncc_blocks(img, true, 5)
    got = ncc_search(img.cuda(), centers.cuda(), tmpl.cuda(),
                     search_radius=16, patch_radius=5)
    want = ncc_search(img, centers, tmpl, search_radius=16, patch_radius=5)
    same = (got[0].cpu() == want[0]).all(1)
    err = float((got[1].cpu() - want[1]).abs()[same].max())
    log(f"ncc_search G=43 N={N_LOOP} card against cpu: same best pixel on "
        f"{float(same.float().mean()):.4f} of the centres, max score diff "
        f"{err}")
    check("ncc_search", {"same best pixel on >= 99%":
                         float(same.float().mean()) >= 0.99,
                         "scores within 1e-4": err <= 1e-4})


def kernel_counters():
    from coslam_torch.ops import kernel_wrappers
    return kernel_wrappers()


def launch_checks(launches: dict, search: bool) -> dict:
    """What a path's kernel counts must show: build_pyramid, klt_track and
    ncc_blocks launched, ncc_search too where the path closes a loop
    (``search``), and the window kernel not at all (its NCC uses are
    ncc_blocks and ncc_search now)."""
    need = ["build_pyramid", "klt_track", "ncc_blocks"] + \
        (["ncc_search"] if search else [])
    return {**{f"{k} launched": launches[k] > 0 for k in need},
            "extract_windows not launched": launches["extract_windows"] == 0}


def time_attempts(eng, device):
    """Record the wall time of every merge attempt and loop-closure attempt
    of ``eng`` into ``eng.attempts`` as (kind, frame, ms, committed),
    between device syncs."""
    eng.attempts = []

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def wrap(name, kind, tried, committed):
        inner = getattr(eng, name)

        def timed(pyr):
            n0 = committed()
            sync()
            t0 = time.perf_counter()
            inner(pyr)
            sync()
            if tried():
                eng.attempts.append((kind, eng.frame,
                                     (time.perf_counter() - t0) * 1e3,
                                     committed() > n0))
        setattr(eng, name, timed)
    wrap("_try_merge", "merge", lambda: True, lambda: len(eng.merge_log))
    wrap("_try_loop_closure", "loop",
         lambda: eng._last_loop_attempt == eng.frame,
         lambda: len(eng.loop_log))


def engine_copy(eng):
    """A deep copy of ``eng`` that runs the engine's own merge and loop
    methods (the timing wrappers of time_attempts stay with ``eng``)."""
    import copy
    new = object.__new__(type(eng))
    new.__dict__.update(copy.deepcopy({
        k: v for k, v in eng.__dict__.items()
        if k not in ("_try_merge", "_try_loop_closure", "attempts",
                     "snapshots", "syncs")}))
    return new


class SyncCounter:
    """Counts the synchronizing CUDA calls made while it is entered (under
    torch.cuda.set_sync_debug_mode("warn"): a blocking copy, a stream or
    event sync), in all and inside the tracked step (``fused.frame_step``,
    also where ``frame_steps_scan`` calls it). ``explicit_syncs`` counts
    apart the calls of ``torch.cuda.synchronize()`` that the package makes
    (``util.to_host``, the stage clock), which the debug mode does not
    report; this script's own (the wall clocks) are not counted."""

    def __init__(self):
        self.total = 0
        self.in_step = 0
        self.explicit_syncs = 0

    def _synchronize(self, device=None):
        caller = sys._getframe(1).f_globals.get("__name__", "")
        if caller.startswith("coslam_torch"):
            self.explicit_syncs += 1
        return self._sync(device)

    def _seen(self, message, *args, **kw):
        if "synchronizing CUDA operation" not in str(message):
            return
        self.total += 1
        f = sys._getframe()
        while f is not None:
            if f.f_code is self._step:
                self.in_step += 1
                return
            f = f.f_back

    def __enter__(self):
        from coslam_torch.slam.fused import frame_step
        self._step = frame_step.__code__
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._seen
        torch.cuda.set_sync_debug_mode("warn")
        self._sync = torch.cuda.synchronize
        torch.cuda.synchronize = self._synchronize
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize = self._sync
        torch.cuda.set_sync_debug_mode(0)
        self._warnings.__exit__(*exc)


def reset_peak_memory() -> dict:
    """Set every card's peak-allocation counter to its current use.
    Returns that use per card in MiB: what earlier phases still hold,
    which every later peak includes."""
    held = {}
    for d in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(d)
        held[f"cuda:{d}"] = round(torch.cuda.memory_allocated(d) / 2 ** 20, 1)
    return held


def peak_memory_mib() -> dict:
    """torch.cuda.max_memory_allocated of every card since the last
    reset_peak_memory, in MiB."""
    return {f"cuda:{d}": round(torch.cuda.max_memory_allocated(d) / 2 ** 20,
                               1) for d in range(torch.cuda.device_count())}


def run_engine(cfg, K, frames, device, snapshot_when=None,
               sync_each: bool = True, count_syncs: bool = False,
               **engine_kw):
    """Drive a fresh engine (keyword arguments ``engine_kw``: the modes)
    over ``frames`` [F, C, H, W]. Returns (engine, per-frame wall ms, and
    the kernel launches of this run: the counts are set to 0 just before
    it). Each frame's wall ends in a device sync unless ``sync_each`` is
    False (the chunk and overlap modes, whose point is not to wait: there
    the last frame's wall ends in one). With ``count_syncs`` the
    synchronizing calls of the run are counted into ``engine.syncs`` (a
    SyncCounter). Merge and loop attempts are timed into
    ``engine.attempts``. Before each frame for which
    ``snapshot_when(engine)`` holds, a copy of the engine is kept (untimed)
    in ``engine.snapshots``: the last three, as (frame, copy). The peak
    device memory of the run, per card, is kept in ``engine.peak_mem``, and
    what was allocated when the run started in ``engine.held_mem``."""
    import collections
    import contextlib
    from coslam_torch.slam.pipeline import CoSlamEngine
    C = cfg.num_cameras
    eng = CoSlamEngine(cfg, K, np.zeros((C, 5), np.float32), device=device,
                       **engine_kw)
    time_attempts(eng, device)
    eng.snapshots = collections.deque(maxlen=3)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    frame_ms = []
    eng.syncs = SyncCounter() if count_syncs else None
    held = reset_peak_memory() if device != "cpu" else None
    with eng.syncs or contextlib.nullcontext():
        for f in range(frames.shape[0]):
            if snapshot_when is not None and snapshot_when(eng):
                eng.snapshots.append((f, engine_copy(eng)))
            t0 = time.perf_counter()
            eng.process_frame(frames[f].to(device))
            if device == "cuda" and (sync_each or f == len(frames) - 1):
                torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {name: fn.launches for name, fn in counters.items()}
    eng.peak_mem = peak_memory_mib() if device != "cpu" else None
    eng.held_mem = held
    return eng, np.asarray(frame_ms), launches


def frame_times(eng, frame_ms):
    """(median over all frames, tracked-frame median, tracked-frame p90)."""
    tracked = [s["frame"] for s in eng.stats_log if "med_err" in s]
    trk = frame_ms[tracked] if tracked else frame_ms
    return (float(np.median(frame_ms)), float(np.median(trk)),
            float(np.percentile(trk, 90)))


def failed_checks(name: str, checks: dict) -> list[str]:
    """The names of the checks that failed, each after ``name``."""
    return [f"{name}: {k}" for k, ok in checks.items() if not ok]


def check(name: str, checks: dict):
    bad = failed_checks(name, checks)
    if bad:
        raise AssertionError(f"checks failed: {bad}")


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
    # a copy before frame PROFILE_WARM[0] for the profile phase
    eng, frame_ms, launches = run_engine(
        cfg, K, frames, "cuda", count_syncs=True,
        snapshot_when=lambda e: e.frame == PROFILE_WARM[0])
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
    n_trk = sum("med_err" in s for s in eng.stats_log)
    log(f"main path: {eng.syncs.total} synchronizing calls over {n_trk} "
        f"tracked frames ({eng.syncs.total / n_trk:.3f} a tracked frame), "
        f"{eng.syncs.in_step} inside frame_step; explicit "
        f"torch.cuda.synchronize {eng.syncs.explicit_syncs} "
        f"({eng.syncs.explicit_syncs / n_trk:.3f} a tracked frame); card "
        f"{card}")
    log(f"main path: peak device memory {eng.peak_mem} MiB (held at its "
        f"start {eng.held_mem}); card {card}")
    check("main path", {
        "frame_step never waits on the host": eng.syncs.in_step == 0,
        "<= 2 synchronizing calls a tracked frame":
            eng.syncs.total <= 2 * n_trk,
        "bootstrapped": eng.bootstrapped,
        ">=3 keyframes": len(eng.kf_frames) >= 3,
        "BA ran": eng.ba_runs >= 1,
        "finite poses": bool(np.isfinite(Rs).all() and np.isfinite(ts).all()),
        "finite map": bool(len(ids) > 0 and np.isfinite(xyz).all()
                           and np.isfinite(cov).all()),
        "trajectory shape": Rs.shape == (FRAMES, 3, 3)
        and ts.shape == (FRAMES, 3),
        "ATE < 2% of path": ate < 0.02 * path,
        **launch_checks(launches, search=False),
    })
    return launches, (eng.snapshots[0][1], frames), len(eng.kf_frames)


def phase_modes(card: str, frames, n_kf_default: int):
    """The production mono scene of the main path (the same 100 frames) in
    the reference's engine modes at once: chunk=4, overlap=True,
    async_ba=True, with no device sync between frames. Every frame posed
    and logged, ATE under 2% of the path, at least half the default
    mode's keyframes (the band of tests/test_chunk_mode.py), two or more
    BAs dispatched to the side stream, every one applied or cancelled and
    at least one applied once its event completed (not through
    max_defer), the path's kernels launched (build_pyramid on every frame,
    klt_track on every tracked one), and no synchronizing call inside the
    tracked step."""
    from coslam_torch.io.ate import ate_rmse, camera_centers
    from coslam_torch.io.synthetic import orbit_trajectory
    cfg = production_cfg(1)
    Rs_gt, ts_gt = orbit_trajectory(FRAMES, forward=0.04)
    t_run = time.perf_counter()
    eng, frame_ms, launches = run_engine(
        cfg, KPROD[None], frames, "cuda", sync_each=False, count_syncs=True,
        chunk=4, overlap=True, async_ba=True)
    eng._apply_pending_ba()
    # the trajectory drains the last chunk's frames: their launches count
    Rs, ts = eng.trajectory(0, correct=True)
    launches = {k: fn.launches for k, fn in kernel_counters().items()}
    run_s = time.perf_counter() - t_run
    c_gt = camera_centers(Rs_gt, ts_gt)
    path = float(np.linalg.norm(np.diff(c_gt, axis=0), axis=-1).sum())
    ate = ate_rmse(Rs, ts, Rs_gt, ts_gt)
    logged = [s["frame"] for s in eng.stats_log]
    boot = boot_frame(eng)
    trk = frame_ms[boot + 1:] if boot is not None else frame_ms
    n_trk = sum("med_err" in s for s in eng.stats_log)
    ba = eng.ba_async
    log(f"modes: keyframes {eng.kf_frames} ({len(eng.kf_frames)}, default "
        f"mode {n_kf_default}); BA {ba}")
    log(f"modes: ATE {ate:.6f} over a {path:.4f} path "
        f"({100 * ate / path:.4f}%)")
    log(f"modes: per-call wall after the bootstrap (host, no sync between "
        f"frames) median {float(np.median(trk)):.3f} ms, p90 "
        f"{float(np.percentile(trk, 90)):.3f} ms, mean "
        f"{float(trk.mean()):.3f} ms a tracked frame; total {run_s:.2f} s; "
        f"card {card}")
    log(f"modes: {eng.syncs.total} synchronizing calls over {n_trk} tracked "
        f"frames ({eng.syncs.total / n_trk:.3f} a tracked frame), "
        f"{eng.syncs.in_step} inside frame_step, explicit "
        f"torch.cuda.synchronize {eng.syncs.explicit_syncs} "
        f"({eng.syncs.explicit_syncs / n_trk:.3f} a tracked frame); timing "
        f"{ {k: round(v, 4) for k, v in sorted(eng.timing.items())} }")
    log(f"modes: kernel launches {launches}; peak device memory "
        f"{eng.peak_mem} MiB (held at its start {eng.held_mem}); card {card}")
    check("modes", {
        "every frame posed": Rs.shape == (FRAMES, 3, 3)
        and bool(np.isfinite(Rs).all() and np.isfinite(ts).all()),
        "every frame logged once": logged == list(range(FRAMES)),
        "buffers drained": not eng._chunk_buf
        and eng._chunk_pending is None and eng._pending_fs is None,
        "ATE < 2% of path": ate < 0.02 * path,
        "keyframes >= half the default mode's":
            len(eng.kf_frames) >= 0.5 * n_kf_default,
        ">= 2 BAs dispatched asynchronously": ba["dispatched"] >= 2,
        "every BA applied or cancelled": eng._pending_ba is None
        and ba["dispatched"] == ba["ready"] + ba["deferred"]
        + ba["flushed"] + ba["cancelled"],
        "a BA applied through its event": ba["ready"] >= 1,
        "build_pyramid on every frame": launches["build_pyramid"] == FRAMES,
        "klt_track on every tracked frame":
            launches["klt_track"] == FRAMES - 1,
        "ncc_blocks launched": launches["ncc_blocks"] > 0,
        "frame_step never waits on the host": eng.syncs.in_step == 0,
    })
    return launches


def phase_syncs(card: str, n: int = 40):
    """Only the count of synchronizing calls: the default mono engine over
    the main path's first ``n`` frames at the production configuration.
    It uses nothing newer than the engine's default mode, so it runs
    against an older version of the package put beside this script."""
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence)
    Rs_gt, ts_gt = orbit_trajectory(FRAMES, forward=0.04)
    frames = render_sequence(make_room(np.random.default_rng(0), size=10.0),
                             KPROD, Rs_gt[:n], ts_gt[:n], H, W,
                             device="cuda")[:, None]
    eng, frame_ms, _ = run_engine(production_cfg(1), KPROD[None], frames,
                                  "cuda", count_syncs=True)
    n_trk = sum("med_err" in s for s in eng.stats_log)
    med, trk, p90 = frame_times(eng, frame_ms)
    rec = dict(frames=n, tracked=n_trk, syncs=eng.syncs.total,
               syncs_per_tracked_frame=eng.syncs.total / n_trk,
               in_frame_step=eng.syncs.in_step,
               in_frame_step_per_tracked_frame=eng.syncs.in_step / n_trk,
               tracked_median_ms=trk, tracked_p90_ms=p90, card=card)
    log(f"syncs: {json.dumps(rec)}")
    return rec


def small_inputs():
    """(cfg, K, frames, Rs_gt, ts_gt) of the one-camera agreements: the
    room at small_test_config(1, 150, 200), 30 frames, forward 0.06."""
    from coslam_torch.config import small_test_config
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence)
    h, w, n = 150, 200, 30
    K = np.array([[[180.0, 0, 100], [0, 180.0, 75], [0, 0, 1]]], np.float32)
    Rs_gt, ts_gt = orbit_trajectory(n, forward=0.06)
    frames = render_sequence(make_room(np.random.default_rng(0), size=10.0),
                             K[0], Rs_gt, ts_gt, h, w, device="cpu")[:, None]
    return small_test_config(1, h, w), K, frames, Rs_gt[None], ts_gt[None]


def two_camera_inputs():
    """(cfg, K, frames, Rs_gt, ts_gt) of the two-camera agreements: the
    20-frame rig of tests/test_pipeline_multicam.py
    (small_test_config(2, 150, 200), baseline 1.0, forward 0.06)."""
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
    return small_test_config(C, h, w), np.repeat(K1[None], C, 0), frames, \
        Rs_gt, ts_gt


LOOP_AGE = 60                    # the cut loop scene's dormant age


def loop_inputs():
    """(cfg, K, frames, Rs_gt, ts_gt) of the loop agreement: the mono_loop
    scene cut to 150x200 (f = 156.25) and 200 frames, its first 181, with
    the closure thresholds of tests/test_loop_closure.py (closures 20
    apart, 12 dormant projections, 7 inliers) and points dormant after
    LOOP_AGE frames (the cut dwell lasts ~100). The run stops before the
    second closure attempt (frame 186), whose Sim(3) scale evidence sits
    on its acceptance threshold: one card run took a scale of 1.44 where
    the CPU kept 1.0."""
    import dataclasses
    from coslam_torch.config import small_test_config
    h, w, n_run = 150, 200, 181
    K = KPROD * np.float32(w / W)
    K[2, 2] = 1.0
    frames, Rs_gt, ts_gt = mono_loop_scene(200, "cpu", h, w, K)
    cfg = small_test_config(1, h, w)
    cfg = cfg.replace(p=dataclasses.replace(
        cfg.p, loop_dormant_age=LOOP_AGE, loop_min_interval=20,
        loop_overlap_min=12, loop_min_inliers=7))
    return cfg, K[None], frames[:n_run], Rs_gt[:n_run], ts_gt[:n_run]


# the CPU side of each card-against-CPU agreement: its inputs and modes
CPU_RUNS = {"small": (small_inputs, {}),
            "non_fused": (small_inputs, dict(use_fused=False)),
            "two_camera": (two_camera_inputs, {}),
            "loop": (loop_inputs, {})}


class RunSummary:
    """What the agreement checks read of an engine run: its logs and its
    corrected trajectories (with and without chain scales), small enough
    to come back from the worker process that made the CPU runs."""

    def __init__(self, eng):
        self.cfg = eng.cfg
        self.stats_log = eng.stats_log
        self.group_id = eng.group_id
        self.kf_frames = list(eng.kf_frames)
        self.loop_log = list(eng.loop_log)
        self._trajs = {(c, cs): eng.trajectory(c, True, chain_scales=cs)
                       for c in range(eng.cfg.num_cameras)
                       for cs in (False, True)}

    def trajectory(self, c: int, correct: bool = True,
                   chain_scales: bool = False):
        if not correct:
            raise ValueError("a RunSummary keeps the corrected trajectories")
        return self._trajs[(c, chain_scales)]


def cpu_run(name: str) -> RunSummary:
    """The CPU run ``name`` of CPU_RUNS (in the worker process: it runs
    beside the card's phases, on cores their host path leaves free)."""
    torch.set_num_threads(4)
    make, kw = CPU_RUNS[name]
    cfg, K, frames, _, _ = make()
    eng, _, _ = run_engine(cfg, K, frames, "cpu", **kw)
    return RunSummary(eng)


def phase_non_fused_small_agreement(cpu_runs):
    """The non-fused path (use_fused=False) on the card against the same
    path on the CPU, at the size and in the band of
    phase_small_agreement."""
    cfg, K, frames, Rs_gt, ts_gt = small_inputs()
    gpu, _, launched = run_engine(cfg, K, frames, "cuda", use_fused=False)
    agreement(cpu_runs["non_fused"].result(), gpu, Rs_gt, ts_gt, 0.20,
              "non-fused small input")
    check("non-fused small input", launch_checks(launched, search=False))


def phase_multicam_path(card: str):
    """threecam_dyn at the production configuration, end to end on the
    card: the wide-baseline bootstrap at frame 0, keyframes and BA,
    finite poses and map, every camera's ATE under 2% of camera 0's path,
    dynamic points on the last tracked frame, inter-camera points, and the
    path's kernels launched. 100 frames: no group merge is attempted (the
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
    # a copy before frame PROFILE_WARM[1] for the profile phase
    eng, frame_ms, launches = run_engine(
        cfg, K, frames, "cuda",
        snapshot_when=lambda e: e.frame == PROFILE_WARM[1])
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
    log(f"threecam_dyn: peak device memory {eng.peak_mem} MiB (held at its "
        f"start {eng.held_mem}); card {card}")
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
        **launch_checks(launches, search=False),
    })
    return launches, (eng.snapshots[0][1], frames)


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


def phase_small_agreement(cpu_runs):
    """The mono engine on the card against the CPU at the CPU tests' size
    (small_test_config(1, 150, 200), 30 frames), under the ATE bound of
    tests/test_pipeline_mono.py."""
    cfg, K, frames, Rs_gt, ts_gt = small_inputs()
    gpu, _, _ = run_engine(cfg, K, frames, "cuda")
    agreement(cpu_runs["small"].result(), gpu, Rs_gt, ts_gt, 0.20,
              "small input")


def phase_multicam_small_agreement(cpu_runs):
    """The two-camera engine on the card against the CPU on the 20-frame
    rig of tests/test_pipeline_multicam.py (small_test_config(2, 150, 200),
    baseline 1.0, forward 0.06), under that file's ATE bound (0.25); both
    bootstrap at frame 0. Returns the card's run (the mesh agreement's
    one-card side)."""
    cfg, K, frames, Rs_gt, ts_gt = two_camera_inputs()
    cpu = cpu_runs["two_camera"].result()
    gpu, _, launched = run_engine(cfg, K, frames, "cuda")
    agreement(cpu, gpu, Rs_gt, ts_gt, 0.25, "two-camera small input")
    check("two-camera small input", {
        "bootstrap at frame 0": boot_frame(cpu) == boot_frame(gpu) == 0,
        **launch_checks(launched, search=False)})
    return gpu


def phase_loop_small_agreement(cpu_runs):
    """Loop closure on the card against the CPU at the CPU tests' size
    (loop_inputs). Both commit a closure anchored on the dormant map,
    their first closures at most one grouping tick (5 frames) apart,
    camera centres within 5% of the path (RMS, after Sim(3) alignment).
    (The 88-frame scene of tests/test_loop_closure.py is not used here:
    on this package's render its one closure attempt lands on a knife
    edge, ~15 px of drift against a 16 px search, and commits or not with
    the CPU's thread count; its CPU test feeds the JAX package's
    render.)"""
    from coslam_torch.io.ate import ate_rmse, camera_centers, umeyama
    cfg, K, frames, Rs_gt, ts_gt = loop_inputs()
    age = LOOP_AGE
    gpu, _, launched = run_engine(cfg, K, frames, "cuda")
    cpu = cpu_runs["loop"].result()
    trajs = [e.trajectory(0, True, chain_scales=True) for e in (cpu, gpu)]
    c_cpu, c_gpu = (camera_centers(*tr) for tr in trajs)
    s, R, t = umeyama(c_gpu, c_cpu)
    gaps = np.linalg.norm((s * (R @ c_gpu.T)).T + t - c_cpu, axis=-1)
    rms = float(np.sqrt(np.mean(gaps ** 2)))
    path = float(np.linalg.norm(np.diff(c_cpu, axis=0), axis=-1).sum())
    ates = [ate_rmse(*tr, Rs_gt, ts_gt) for tr in trajs]
    log(f"loop small input: closures cpu {cpu.loop_log} card {gpu.loop_log}")
    log(f"loop small input: centre gap rms {rms:.6f} over a {path:.4f} "
        f"path ({100 * rms / path:.4f}% of it, bound 5%); ATE cpu "
        f"{ates[0]:.6f} card {ates[1]:.6f}; card launches {launched}")

    def anchored(eng):
        return any(lc["frame"] - lc["f_anchor"] >= age for lc in eng.loop_log)
    check("loop small input", {
        "closure on the CPU anchored on the dormant map": anchored(cpu),
        "closure on the card anchored on the dormant map": anchored(gpu),
        "first closures one grouping tick apart":
            bool(cpu.loop_log and gpu.loop_log) and
            abs(cpu.loop_log[0]["frame"] - gpu.loop_log[0]["frame"]) <= 5,
        "centres within 5% of path (rms)": rms < 0.05 * path,
        **launch_checks(launched, search=True)})


def splitmerge_scene(n: int, dev):
    """The splitmerge scene of examples/accuracy_bench.py
    (config_splitmerge with _rig_frames) from seed 0 where that script
    uses 7: two cameras on a rig (baseline 1.0, orbit_trajectory forward
    0.02); camera 1 yaws to 1.2 rad over frames 0.2n-0.4n, holds until
    0.55n and returns by 0.75n. The generator is drawn in that script's
    order (one uniform, the room) and the frames are rounded to float16.
    Returns (frames [F, 2, H, W] on ``dev``, Rs_gt [2, F, 3, 3],
    ts_gt [2, F, 3])."""
    from coslam_torch.geometry.se3 import so3_exp_np
    from coslam_torch.io.synthetic import (make_room, multi_cam_rig,
                                           orbit_trajectory, render_sequence)
    sep0, sep1, ret0, ret1 = (int(n * a) for a in (0.2, 0.4, 0.55, 0.75))

    def yaw1(f):
        if f < sep0 or f >= ret1:
            return 0.0
        if f < sep1:
            return 1.2 * (f - sep0) / (sep1 - sep0)
        if f < ret0:
            return 1.2
        return 1.2 * (ret1 - f) / (ret1 - ret0)

    Rr, tr = orbit_trajectory(n, forward=0.02)
    rot_c, offs_c = multi_cam_rig(2, baseline=1.0)
    Rs = np.zeros((2, n, 3, 3), np.float32)
    ts = np.zeros((2, n, 3), np.float32)
    for f in range(n):
        c_rig = -Rr[f].T @ tr[f]
        for c in range(2):
            Rc = rot_c[c] @ Rr[f]
            if c == 1 and yaw1(f):
                Rc = so3_exp_np(np.array([0.0, yaw1(f), 0.0])) @ Rc
            Rs[c, f] = Rc
            ts[c, f] = -Rc @ (c_rig + Rr[f].T @ offs_c[c])
    rng = np.random.default_rng(0)
    rng.uniform()
    planes = make_room(rng, size=10.0)
    frames = torch.stack([render_sequence(planes, KPROD, Rs[c], ts[c], H, W,
                                          device=dev) for c in range(2)],
                         dim=1)
    return frames.half().float(), Rs, ts


def mono_loop_scene(n: int, dev, h: int = H, w: int = W, K=KPROD):
    """The mono_loop scene of examples/accuracy_bench.py (config_mono_loop)
    from seed 0 where that script uses 7: a lateral sweep maps the back
    wall (to 0.15n), the camera yaws out to 1.2 rad (to 0.3n), dwells (to
    0.82n), yaws back (to 0.92n) and dwells on the revisit; the generator
    drawn in that script's order, the frames rounded to float16. Returns
    (frames [F, 1, h, w] on ``dev``, Rs_gt [F, 3, 3], ts_gt [F, 3])."""
    from coslam_torch.geometry.se3 import so3_exp_np
    from coslam_torch.io.synthetic import make_room, render_sequence
    f_map, f_out, f_back, f_home = (int(n * a)
                                    for a in (0.15, 0.30, 0.82, 0.92))
    yaws = np.concatenate([
        np.zeros(f_map), np.linspace(0, 1.2, f_out - f_map),
        np.full(f_back - f_out, 1.2), np.linspace(1.2, 0.0, f_home - f_back),
        np.zeros(n - f_home)])
    Rs = np.zeros((n, 3, 3), np.float32)
    ts = np.zeros((n, 3), np.float32)
    for f in range(n):
        Rs[f] = so3_exp_np(np.array([0.0, yaws[f], 0.0]))
        c = np.array([0.9 * np.sin(0.06 * f), 0.05 * np.sin(0.1 * f),
                      0.002 * f], np.float32)
        ts[f] = -Rs[f] @ c
    rng = np.random.default_rng(0)
    rng.uniform()
    frames = render_sequence(make_room(rng, size=10.0), K, Rs, ts, h, w,
                             device=dev)[:, None]
    return frames.half().float(), Rs, ts


def attempt_summary(eng, label: str):
    """Log the merge and loop logs and the wall time of every attempt."""
    log(f"{label}: merge_log " + json.dumps([
        {k: (round(v, 6) if isinstance(v, float) else v)
         for k, v in m.items()} for m in eng.merge_log]))
    log(f"{label}: loop_log " + json.dumps([
        {k: (round(v, 6) if isinstance(v, float) else v)
         for k, v in m.items()} for m in eng.loop_log]))
    for kind in ("merge", "loop"):
        rows = [(f, round(ms, 3), ok) for k, f, ms, ok in eng.attempts
                if k == kind]
        log(f"{label}: {kind} attempts (frame, wall ms, committed): {rows}")


def phase_splitmerge_path(card: str):
    """splitmerge at the production configuration over 400 frames: the
    groups split in frames 160-220, a merge is logged at frame >= 220, the
    groups are rejoined at the last frame, every camera's ATE (chain
    scales, as the accuracy harness computes it) under 2% of camera 0's
    path, finite poses and map, the path's kernels launched. Returns (the
    launches, a copy of the engine from two frames before the first
    merge, the frames, that copy's next frame)."""
    from coslam_torch.io.ate import ate_rmse, camera_centers
    from coslam_torch.slam.pipeline import GROUPING_INTERVAL
    n = LONG_FRAMES
    t0 = time.perf_counter()
    frames, Rs_gt, ts_gt = splitmerge_scene(n, "cuda")
    torch.cuda.synchronize()
    log(f"splitmerge: rendered {tuple(frames.shape)} in "
        f"{time.perf_counter() - t0:.2f} s")
    cfg = production_cfg(2)
    K = np.repeat(KPROD[None], 2, 0)
    t_run = time.perf_counter()
    # copies of the engine, split and unmerged, two frames before each
    # grouping tick (merges are attempted on the tick only): the last one
    # is taken two frames before the first merge, which the profile
    # replays from it
    eng, frame_ms, launches = run_engine(
        cfg, K, frames, "cuda", snapshot_when=lambda e: not e.merge_log and
        len(set(e.group_id.tolist())) > 1
        and e.frame - e._last_grouping == GROUPING_INTERVAL - 2)
    trajs = [eng.trajectory(c, correct=True, chain_scales=True)
             for c in range(2)]
    run_s = time.perf_counter() - t_run
    ids, xyz, cov = eng.map_points()
    path = float(np.linalg.norm(np.diff(camera_centers(Rs_gt[0], ts_gt[0]),
                                        axis=0), axis=-1).sum())
    ates = [ate_rmse(*trajs[c], Rs_gt[c], ts_gt[c]) for c in range(2)]
    med, trk, p90 = frame_times(eng, frame_ms)
    gh = eng.group_hist
    trans = [(i, g) for i, g in enumerate(gh) if i and g != gh[i - 1]]
    n_tracked = sum("med_err" in s for s in eng.stats_log)
    log(f"splitmerge: bootstrap {boot_frame(eng)} keyframes "
        f"{len(eng.kf_frames)} ba_runs {eng.ba_runs} map_points {len(ids)}")
    log(f"splitmerge: group transitions {trans}")
    attempt_summary(eng, "splitmerge")
    log(f"splitmerge: ATE per camera {[round(a, 6) for a in ates]} over a "
        f"{path:.4f} camera-0 path "
        f"({[round(100 * a / path, 4) for a in ates]}%)")
    log(f"splitmerge: per-frame ms median {med:.3f} (all {n}), "
        f"tracked-frame median {trk:.3f}, p90 {p90:.3f}, total "
        f"{run_s:.2f} s; card {card}")
    log(f"splitmerge: kernel launches {launches}, per tracked frame "
        f"{ {k: round(v / max(n_tracked, 1), 3) for k, v in launches.items()} }")
    log(f"splitmerge: peak device memory {eng.peak_mem} MiB (held at its "
        f"start {eng.held_mem}); card {card}")
    check("splitmerge", {
        "groups split in frames 160-220":
            any(g[0] != g[1] for g in gh[160:220]),
        "merge at frame >= 220":
            any(m["frame"] >= 220 for m in eng.merge_log),
        "groups rejoined at the last frame": gh[-1][0] == gh[-1][1],
        "every camera's ATE < 2% of the camera-0 path":
            max(ates) < 0.02 * path,
        "finite poses": all(np.isfinite(R).all() and np.isfinite(t).all()
                            for R, t in trajs),
        "finite map": bool(len(ids) > 0 and np.isfinite(xyz).all()
                           and np.isfinite(cov).all()),
        **launch_checks(launches, search=False),
    })
    f0, snap = eng.snapshots[-1]    # two frames before the first merge
    return launches, snap, frames, f0


def phase_mono_loop_path(card: str):
    """mono_loop at the production configuration over 400 frames, default
    closure thresholds: a closure anchored at least loop_dormant_age
    frames before its frame, the ATE (chain scales) under 2% of the path,
    and every G = 43 search of a closure attempt one launch of
    ncc_search."""
    import coslam_torch.slam.loop as loop_mod
    from coslam_torch.ops.ncc import ncc_search
    from coslam_torch.io.ate import ate_rmse, camera_centers
    n = LONG_FRAMES
    t0 = time.perf_counter()
    frames, Rs_gt, ts_gt = mono_loop_scene(n, "cuda")
    torch.cuda.synchronize()
    log(f"mono_loop: rendered {tuple(frames.shape)} in "
        f"{time.perf_counter() - t0:.2f} s")
    cfg = production_cfg(1)
    searches = []       # kernel launches of each closure's ncc_search
    search = loop_mod.ncc_search

    def counted_search(*args, **kw):
        n0 = ncc_search.launches
        out = search(*args, **kw)
        searches.append(ncc_search.launches - n0)
        return out
    loop_mod.ncc_search = counted_search
    t_run = time.perf_counter()
    try:
        eng, frame_ms, launches = run_engine(cfg, KPROD[None], frames,
                                             "cuda")
    finally:
        loop_mod.ncc_search = search
    Rs, ts = eng.trajectory(0, correct=True, chain_scales=True)
    run_s = time.perf_counter() - t_run
    ids, xyz, cov = eng.map_points()
    path = float(np.linalg.norm(np.diff(camera_centers(Rs_gt, ts_gt),
                                        axis=0), axis=-1).sum())
    ate = ate_rmse(Rs, ts, Rs_gt, ts_gt)
    med, trk, p90 = frame_times(eng, frame_ms)
    n_tracked = sum("med_err" in s for s in eng.stats_log)
    age = cfg.p.loop_dormant_age
    log(f"mono_loop: bootstrap {boot_frame(eng)} keyframes "
        f"{len(eng.kf_frames)} ba_runs {eng.ba_runs} map_points {len(ids)}")
    attempt_summary(eng, "mono_loop")
    log(f"mono_loop: ATE {ate:.6f} over a {path:.4f} path "
        f"({100 * ate / path:.4f}%)")
    log(f"mono_loop: per-frame ms median {med:.3f} (all {n}), "
        f"tracked-frame median {trk:.3f}, p90 {p90:.3f}, total "
        f"{run_s:.2f} s; card {card}")
    log(f"mono_loop: kernel launches {launches}, {n_tracked} tracked "
        f"frames; ncc_search launches of each closure search (G = 43): "
        f"{searches}")
    log(f"mono_loop: peak device memory {eng.peak_mem} MiB (held at its "
        f"start {eng.held_mem}); card {card}")
    check("mono_loop", {
        "closure anchored on the dormant map":
            any(lc["frame"] - lc["f_anchor"] >= age for lc in eng.loop_log),
        "ATE < 2% of path": ate < 0.02 * path,
        "finite poses": bool(np.isfinite(Rs).all() and np.isfinite(ts).all()),
        "finite map": bool(len(ids) > 0 and np.isfinite(xyz).all()
                           and np.isfinite(cov).all()),
        "each closure search one ncc_search launch":
            bool(searches) and all(k == 1 for k in searches),
        **launch_checks(launches, search=True),
    })
    return launches


PROFILE_FRAMES = 3               # tracked frames a profile phase traces
PROFILE_WARM = (30, 20)          # where mono's and threecam_dyn's start


def range_launches(prof, names, n: int) -> dict:
    """Launches and device time per frame inside each named
    record_function range of a finished torch.profiler run over ``n``
    frames, read from the raw trace (the FunctionEvent tree and its
    aggregation take 34-58 s over a profile's ~10^5 events): the CUDA
    runtime calls (cudaLaunchKernel, cudaLaunchCooperativeKernel,
    cudaMemcpyAsync, ...) that start inside a range on the host, and the
    device activities they started, matched by CUPTI correlation id (the
    kernels of a ctypes library are attached to no operator, so the
    range's own device time does not see them). The host drives the card
    from one thread here, so a runtime call belongs to the ranges whose
    span holds its start."""
    import bisect
    cuda = torch.autograd.DeviceType.CUDA
    on_device, runtime, spans = {}, [], {k: [] for k in names}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            on_device.setdefault(e.correlation_id(), []).append(e)
        elif e.name().startswith("cu"):
            runtime.append((e.start_ns(), e.correlation_id()))
        elif e.name() in spans:
            spans[e.name()].append((e.start_ns(), e.end_ns()))
    runtime.sort()
    starts = [r[0] for r in runtime]
    out = {}
    for name, sp in spans.items():
        acts = [a for t0, t1 in sp
                for _, corr in runtime[bisect.bisect_left(starts, t0):
                                       bisect.bisect_right(starts, t1)]
                for a in on_device.get(corr, [])]
        out[name] = dict(
            calls_per_frame=len(sp) / n,
            launches_per_frame=len(acts) / n,
            device_ms_per_frame=sum(a.duration_ns() for a in acts)
            / 1e6 / n,
            kernels=sorted({a.name()[:60] for a in acts}))
    return out


def phase_profile(eng, frames, warm: int, card: str, table_path,
                  label: str):
    """torch.profiler over the next PROFILE_FRAMES tracked frames of
    ``eng``, an engine
    that has processed frames 0..warm-1: wall and device-busy time per
    frame, the device's idle share, kernel launches per frame, and (to
    ``table_path``, when given) the table of operators by device time."""
    from torch.profiler import ProfilerActivity, profile
    from coslam_torch.examples.profile_ablate import device_busy_us
    n = PROFILE_FRAMES
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in range(warm, warm + n):
            eng.process_frame(frames[f])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    busy_us, launches = device_busy_us(prof)
    busy_ms = busy_us / 1e3 / n
    ranges = range_launches(prof, ("build_pyramid", "klt_track",
                                   "ncc_blocks"), n)

    if table_path:
        os.makedirs(os.path.dirname(os.path.abspath(table_path)),
                    exist_ok=True)
        with open(table_path, "w") as fh:
            fh.write(f"card: {card}; frames {warm}..{warm + n - 1} of the "
                     f"production {label} config\n")
            ka = prof.key_averages()    # aggregated: tens of seconds
            fh.write(ka.table(sort_by="self_device_time_total",
                              row_limit=60))
            fh.write("\n")
            fh.write(ka.table(sort_by="self_cpu_time_total", row_limit=40))
    log(f"profile {label}: {n} tracked frames ({warm}..{warm + n - 1}), wall "
        f"{wall_ms:.3f} ms/frame, device busy {busy_ms:.3f} ms/frame, idle "
        f"share {1.0 - busy_ms / wall_ms:.4f}, {launches / n:.1f} kernel "
        f"launches/frame; merges in the window "
        f"{[m['frame'] for m in eng.merge_log if m['frame'] >= warm]}; "
        f"card {card}")
    for name, rec in ranges.items():
        log(f"profile {label}: inside {name}: {rec}")


DIST_FRAMES = 100                # of the reference's 300 (ACCURACY.md:20)
DIST_RESUME = 80                 # frames of the checkpoint run
DIST_SAVE = 60                   # its checkpoint's frame
DIST_RESIDENT = 20               # frames of the resident-frames run
# the CPU's TV-L1 flow against the card's on the same pair: float32
# elementwise rounding differs (the card contracts multiply-adds), and 180
# primal-dual iterations carry it
FLOW_TOL = 1e-2


def distorted_scene(n_frames: int, dev):
    """The distorted configuration of examples/accuracy_bench.py
    (config_distorted and _rig_frames, seed 0 as on the other paths):
    three cameras on a rig (baseline 1.0, orbit_trajectory forward 0.04)
    with k1 = -0.25, k2 = 0.08 on every camera, the generator drawn in
    that script's order (one uniform, then the room). The views are
    rendered in batches (render_batch, each view with its frame index)
    and warped through the lens (apply_distortion_warp) on ``dev``.
    Returns (frames [F, 3, H, W] f32 on ``dev``, Rs_gt [3, F, 3, 3],
    ts_gt [3, F, 3], kc [3, 5])."""
    from coslam_torch.io.synthetic import (apply_distortion_warp,
                                           make_room, render_batch,
                                           rig_sequence)
    rng = np.random.default_rng(0)
    rng.uniform()
    planes = make_room(rng, size=10.0)
    C = 3
    kc = np.zeros((C, 5), np.float32)
    kc[:, 0], kc[:, 1] = -0.25, 0.08
    Rs, ts = rig_sequence(C, n_frames, baseline=1.0, forward=0.04)
    frames = render_batch(planes, KPROD,
                          Rs.transpose(1, 0, 2, 3).reshape(-1, 3, 3),
                          ts.transpose(1, 0, 2).reshape(-1, 3), H, W,
                          frames=np.repeat(np.arange(n_frames), C),
                          chunk=4 * C, device=dev).reshape(n_frames, C, H, W)
    frames = torch.stack([apply_distortion_warp(frames[:, c], KPROD, kc[c])
                          for c in range(C)], dim=1)
    return frames, Rs, ts, kc


def write_inputs(root: str, frames_u8: np.ndarray, kc: np.ndarray) -> str:
    """One CSRW file and one calibration file a camera, and the input.txt
    of the reference's format naming them. Returns input.txt's path."""
    from coslam_torch.io.calib import write_calib_file
    from coslam_torch.io.loader import write_raw_sequence
    C = frames_u8.shape[1]
    videos, calibs = [], []
    for c in range(C):
        videos.append(os.path.join(root, f"cam{c}.csrw"))
        calibs.append(os.path.join(root, f"cam{c}_calib.txt"))
        write_raw_sequence(videos[c], frames_u8[:, c])
        write_calib_file(calibs[c], KPROD, kc[c])
    path = os.path.join(root, "input.txt")
    with open(path, "w") as f:
        f.write(f"{C}\n" + "0 10\n" * C + "".join(v + "\n" for v in videos)
                + "".join(p + "\n" for p in calibs))
    return path


class FrameClock:
    """Wall time (ms, after a device sync) and synchronizing calls of every
    ``CoSlamEngine.process_frame`` call while entered, however the engine
    is driven (the CLI too). ``syncs``: a SyncCounter entered around
    the whole run."""

    def __init__(self, syncs: "SyncCounter"):
        self.syncs = syncs
        self.ms, self.n_syncs = [], []

    def __enter__(self):
        from coslam_torch.slam.pipeline import CoSlamEngine
        self._orig = CoSlamEngine.process_frame
        clock = self

        def timed(eng, images):
            n0 = clock.syncs.total
            t0 = time.perf_counter()
            out = clock._orig(eng, images)
            torch.cuda.synchronize()
            clock.ms.append((time.perf_counter() - t0) * 1e3)
            clock.n_syncs.append(clock.syncs.total - n0)
            return out
        CoSlamEngine.process_frame = timed
        return self

    def __exit__(self, *exc):
        from coslam_torch.slam.pipeline import CoSlamEngine
        CoSlamEngine.process_frame = self._orig

    def tracked(self, eng, upto: int | None = None):
        """(tracked-frame wall median and p90 ms, synchronizing calls a
        tracked frame) of the calls of frames before ``upto`` (default
        all); the frames tracked are those logged with a reprojection
        error."""
        idx = [s["frame"] for s in eng.stats_log if "med_err" in s
               and (upto is None or s["frame"] < upto)]
        ms = np.asarray(self.ms)[idx]
        return float(np.median(ms)), float(np.percentile(ms, 90)), \
            float(np.asarray(self.n_syncs)[idx].sum() / len(idx))


def aligned_rms(a, b) -> float:
    """RMS camera-centre distance of trajectory ``a`` Sim(3)-aligned to
    ``b`` (two runs with maps of their own)."""
    from coslam_torch.io.ate import camera_centers, umeyama
    ca, cb = camera_centers(*a), camera_centers(*b)
    s, R, t = umeyama(ca, cb)
    d = (s * (R @ ca.T)).T + t - cb
    return float(np.sqrt(np.mean(np.sum(d * d, -1))))


def centre_rms(a, b) -> float:
    """RMS over frames of the camera-centre distance of two trajectories
    in the same map (no alignment)."""
    from coslam_torch.io.ate import camera_centers
    d = camera_centers(*a) - camera_centers(*b)
    return float(np.sqrt(np.mean(np.sum(d * d, -1))))


def phase_distorted_io(card: str):
    """The reference's distorted configuration at full width, read from
    files (ROADMAP A16): 100 of its 300 frames rendered and warped on the
    card (a few views held against the CPU's render and warp), quantized
    to uint8 and written as CSRW videos, calibration files and an
    input.txt; then
    - run A: ``coslam_torch.cli.main`` over the 100 frames (native loader,
      engine on the card, export); every camera's Sim(3)-aligned ATE from
      its exported campose file under 3% of camera 0's path (the
      reference's record over all 300 frames: 2.45%); mappts.txt and
      input_videos.txt parse; build_pyramid on every frame, klt_track on
      every tracked one, ncc_blocks launched;
    - run B: an engine fed by FrameLoader (native) with log_features saves
      a checkpoint at frame 60 and runs to 80; a fresh engine loads it
      (frame, keyframes, groups, merge log and the reference pyramid as
      saved) and runs on from a loader started at frame 60: its tracked
      poses within 1% of run B's camera-0 path (RMS of the camera
      centres, B's path from its bootstrap on) of run B's, or, where the
      two uninterrupted runs A and B bootstrap at the same frame and
      drift further apart than that (Sim(3)-aligned centres over frames
      0-79: the card's atomic sums change order from run to run), within
      that drift; the exported featpts hold every frame after the
      bootstrap of every camera;
    - run C: the first 20 frames resident on the card (no loader, no
      log).
    Recorded: the loader's frames/s alone, the tracked-frame wall medians
    (A: loader-fed; C: resident), synchronizing calls a tracked frame with
    the feature log off (A) and on (B), checkpoint save and load wall,
    and TV-L1 flow on a 3x480x640 pair of these frames on the card (held
    against the CPU within FLOW_TOL px). Every run and check of the phase
    is made; the phase fails at its end if any check failed, naming them
    all."""
    import tempfile
    from coslam_torch import cli
    from coslam_torch.io.ate import ate_rmse, camera_centers
    from coslam_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from coslam_torch.io.export import export_results, load_campose
    from coslam_torch.io.loader import FrameLoader, native_lib
    from coslam_torch.io.synthetic import (apply_distortion_warp, make_room,
                                           render_sequence)
    from coslam_torch.ops.flow import tvl1_flow
    from coslam_torch.slam.pipeline import CoSlamEngine
    n, C = DIST_FRAMES, 3
    t0 = time.perf_counter()
    frames, Rs_gt, ts_gt, kc = distorted_scene(n, "cuda")
    torch.cuda.synchronize()
    log(f"distorted_io: rendered and warped {tuple(frames.shape)} in "
        f"{time.perf_counter() - t0:.2f} s")
    # a few views against the CPU's render and warp
    rng = np.random.default_rng(0)
    rng.uniform()
    planes = make_room(rng, size=10.0)
    views = [(0, 0), (n // 2, 1), (n - 1, 2)]
    cpu = torch.stack([apply_distortion_warp(
        render_sequence(planes, KPROD, Rs_gt[c, f][None], ts_gt[c, f][None],
                        H, W, frames=[f], device="cpu")[0], KPROD, kc[c])
        for f, c in views])
    render_agreement(torch.stack([frames[f, c] for f, c in views]), cpu,
                     "distorted_io (warped)")
    frames_u8 = frames.clamp(0, 255).round().to(torch.uint8).cpu().numpy()
    resident = torch.as_tensor(frames_u8[:DIST_RESIDENT],
                               device="cuda").float()
    c_gt = camera_centers(Rs_gt[0], ts_gt[0])
    path = float(np.linalg.norm(np.diff(c_gt, axis=0), axis=-1).sum())
    counters = kernel_counters()
    with tempfile.TemporaryDirectory() as root:
        inp = write_inputs(root, frames_u8, kc)
        videos = [os.path.join(root, f"cam{c}.csrw") for c in range(C)]
        t0 = time.perf_counter()
        native_lib()                    # g++ builds the loader once
        log(f"distorted_io: native loader built in "
            f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        ld = FrameLoader(videos)
        n_read = sum(1 for _ in ld)
        ld.close()
        loader_fps = n_read / (time.perf_counter() - t0)
        log(f"distorted_io: native loader {n_read} frames of {C}x{H}x{W} "
            f"alone at {loader_fps:.2f} frames/s (native={ld.native}); "
            f"card {card}")
        # run A: the CLI end to end
        out = os.path.join(root, "results")
        for fn in counters.values():
            fn.launches = 0
        held_a = reset_peak_memory()
        with SyncCounter() as sc, FrameClock(sc) as clock_a:
            eng_a = cli.main([inp, "--out", out])
        launches = {k: fn.launches for k, fn in counters.items()}
        peak_a = peak_memory_mib()
        trajs_a = [load_campose(os.path.join(out, f"{c}_campose.txt"))
                   for c in range(C)]
        ates = [ate_rmse(*trajs_a[c], Rs_gt[c], ts_gt[c]) for c in range(C)]
        mappts = np.loadtxt(os.path.join(out, "mappts.txt"), ndmin=2)
        with open(os.path.join(out, "input_videos.txt")) as f:
            sources = f.read().splitlines()
        med_a, p90_a, syncs_a = clock_a.tracked(eng_a)
        log(f"distorted_io: CLI run bootstrap {boot_frame(eng_a)} keyframes "
            f"{eng_a.kf_frames} groups {eng_a.group_id.tolist()} "
            f"map points {len(mappts)}")
        log(f"distorted_io: ATE per camera {[round(a, 6) for a in ates]} "
            f"over a {path:.4f} camera-0 path "
            f"({[round(100 * a / path, 4) for a in ates]}%)")
        log(f"distorted_io: CLI run (loader-fed, no feature log): tracked-"
            f"frame wall median {med_a:.3f} ms, p90 {p90_a:.3f} ms, "
            f"{syncs_a:.3f} synchronizing "
            f"calls a tracked frame; kernel launches {launches}; peak device "
            f"memory {peak_a} MiB (held at its start {held_a}); card {card}")
        failed = failed_checks("distorted_io CLI", {
            "native loader": ld.native and n_read == n,
            "every frame posed": all(R.shape == (n, 3, 3) for R, _ in trajs_a)
            and all(np.isfinite(R).all() and np.isfinite(t).all()
                    for R, t in trajs_a),
            "rotations orthonormal": all(np.abs(np.einsum(
                "fij,fik->fjk", R, R) - np.eye(3)).max() < 1e-2
                for R, _ in trajs_a),
            "every camera's ATE < 3% of the camera-0 path":
                max(ates) < 0.03 * path,
            "mappts.txt parses": mappts.shape[0] > 0
            and mappts.shape[1] == 13 and np.isfinite(mappts).all(),
            "input_videos.txt lists the videos": sources == videos,
            "build_pyramid on every frame": launches["build_pyramid"] == n,
            "klt_track on every tracked frame":
                launches["klt_track"] == n - 1,
            **launch_checks(launches, search=False)})
        # run B: checkpoint at frame 60 and resume
        ck = os.path.join(root, "ck.npz")
        eng_b = CoSlamEngine(production_cfg(C), np.repeat(KPROD[None], C, 0),
                             kc, log_features=True)
        ld = FrameLoader(videos)
        with SyncCounter() as sc, FrameClock(sc) as clock_b:
            for f, fr in zip(range(DIST_RESUME), ld):
                if f == DIST_SAVE:
                    t0 = time.perf_counter()
                    save_checkpoint(ck, eng_b)
                    save_ms = (time.perf_counter() - t0) * 1e3
                    saved = dict(frame=eng_b.frame,
                                 kf_frames=list(eng_b.kf_frames),
                                 group_id=eng_b.group_id.copy(),
                                 merge_log=list(eng_b.merge_log),
                                 pyr=[a.clone() for a in eng_b.pyr_prev.imgs])
                eng_b.process_frame(fr)
        ld.close()
        med_b, _, syncs_b = clock_b.tracked(eng_b)
        t0 = time.perf_counter()
        eng_r = load_checkpoint(ck, CoSlamEngine(
            production_cfg(C), np.repeat(KPROD[None], C, 0), kc))
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        loaded = {
            "frame": eng_r.frame == saved["frame"] == DIST_SAVE,
            "keyframes": eng_r.kf_frames == saved["kf_frames"],
            "groups": np.array_equal(eng_r.group_id, saved["group_id"]),
            "merge log": eng_r.merge_log == saved["merge_log"],
            "reference pyramid": eng_r.pyr_prev is not None
            and all(a.is_cuda and torch.equal(a, b) for a, b in
                    zip(eng_r.pyr_prev.imgs, saved["pyr"])),
        }
        ck_bytes = os.path.getsize(ck)
        ld = FrameLoader(videos, start_frames=[DIST_SAVE] * C)
        for _, fr in zip(range(DIST_RESUME - DIST_SAVE), ld):
            eng_r.process_frame(fr)
        ld.close()
        feat_dir = os.path.join(root, "results_b")
        export_results(feat_dir, eng_b)
        feat_frames = []
        for c in range(C):
            fp = np.loadtxt(os.path.join(feat_dir, f"{c}_featpts.txt"),
                            ndmin=2)
            feat_frames.append(sorted(set(fp[:, 0].astype(int).tolist())))
    boot_b = boot_frame(eng_b)
    # the tracked poses (the resumed engine's chain correction would use
    # its own keyframes)
    trajs_b = [eng_b.trajectory(c, False) for c in range(C)]
    trajs_r = [eng_r.trajectory(c, False) for c in range(C)]
    path_b = float(np.linalg.norm(np.diff(camera_centers(
        *trajs_b[0])[boot_b:], axis=0), axis=-1).sum())
    resume = [centre_rms(trajs_r[c], trajs_b[c]) for c in range(C)]
    boot_a = boot_frame(eng_a)
    drift = [aligned_rms(tuple(a[boot_b:DIST_RESUME] for a in
                               eng_a.trajectory(c, False)),
                         tuple(b[boot_b:] for b in trajs_b[c]))
             for c in range(C)] if boot_a == boot_b else None
    bound = max([0.01 * path_b] + (drift or []))
    log(f"distorted_io: checkpoint save {save_ms:.2f} ms, load "
        f"{load_ms:.2f} ms ({ck_bytes} B); "
        f"card {card}")
    log(f"distorted_io: bootstrap run A {boot_a}, run B {boot_b}; resumed "
        f"against uninterrupted: centre RMS per camera "
        f"{[round(r, 6) for r in resume]} "
        f"({[round(100 * r / path_b, 4) for r in resume]}% of run B's "
        f"camera-0 path {path_b:.4f}); runs A and B apart (Sim(3)-aligned) "
        f"by {drift and [round(100 * d / path_b, 4) for d in drift]}%; "
        f"bound {bound:.6f}")
    _, _, syncs_a_b = clock_a.tracked(eng_a, upto=DIST_RESUME)
    log(f"distorted_io: frames 0-{DIST_RESUME - 1} loader-fed: with the "
        f"feature log (run B) tracked-frame wall median {med_b:.3f} ms, "
        f"{syncs_b:.3f} synchronizing calls a tracked frame; without it "
        f"(run A) {syncs_a_b:.3f}")
    failed += failed_checks("distorted_io resume", {
        **{f"loaded {k}": v for k, v in loaded.items()},
        "resumed trajectory finite": all(np.isfinite(R).all()
                                         and np.isfinite(t).all()
                                         for R, t in trajs_r),
        "resumed within the bound": max(resume) <= bound,
        "featpts: every frame after the bootstrap, every camera":
            all(fr == list(range(boot_b, DIST_RESUME))
                for fr in feat_frames),
    })
    # run C: the same frames resident on the card
    eng_c = CoSlamEngine(production_cfg(C), np.repeat(KPROD[None], C, 0), kc)
    with SyncCounter() as sc, FrameClock(sc) as clock_c:
        for f in range(DIST_RESIDENT):
            eng_c.process_frame(resident[f])
    med_c, _, syncs_c = clock_c.tracked(eng_c)
    med_a_c, _, syncs_a_c = clock_a.tracked(eng_a, upto=DIST_RESIDENT)
    log(f"distorted_io: frames 0-{DIST_RESIDENT - 1}: tracked-frame wall "
        f"median loader-fed {med_a_c:.3f} ms (run A) against resident "
        f"{med_c:.3f} ms (run C, bootstrap {boot_frame(eng_c)}); "
        f"synchronizing calls a tracked frame {syncs_a_c:.3f} and "
        f"{syncs_c:.3f}; card {card}")
    # TV-L1 flow on a pair of these frames, card against CPU
    pair = frames[0], frames[1]
    flow = tvl1_flow(*pair)
    flow_cpu = tvl1_flow(pair[0].cpu(), pair[1].cpu())
    diff = (flow.cpu() - flow_cpu).abs()
    flow_ms = eager_time_ms(lambda: tvl1_flow(*pair), reps=1, trials=3)
    log(f"distorted_io: tvl1_flow {tuple(flow.shape)} on the card "
        f"{flow_ms:.3f} ms (eager, CUDA events); against the CPU max diff {float(diff.max())} px, "
        f"median {float(diff.median())} px; card {card}")
    failed += failed_checks("distorted_io flow", {
        "finite": bool(torch.isfinite(flow).all()),
        f"card within {FLOW_TOL} px of the CPU": float(diff.max()) <= FLOW_TOL,
    })
    if failed:
        raise AssertionError(f"checks failed: {failed}")
    return launches


MESH_FRAMES = 60                 # of fivecam_mesh's 150 (ACCURACY.md:23)
MESH_CHUNK = 6                   # examples/accuracy_bench.py:136
BA_REPS = 5                      # timed solves of each BA, median


def mesh_devices(n: int) -> list[str]:
    """One shard a camera over the visible cards, round robin: on one card
    every shard is cuda:0."""
    from coslam_torch.parallel.mesh import round_robin
    return round_robin(n)


def fivecam_scene(n_frames: int, dev):
    """The fivecam_mesh scene of examples/accuracy_bench.py
    (config_fivecam_mesh and _rig_frames) at the production 480x640 with
    f = 500 where that script cuts to 240x320 for its CPU mesh, seed 0
    where it uses 7: five cameras on a rig (baseline 0.8,
    orbit_trajectory forward 0.04), the generator drawn in that script's
    order (one uniform, then the room), the views rendered in batches and
    rounded to float16 as there. Returns (frames [F, 5, H, W] on ``dev``,
    Rs_gt [5, F, 3, 3], ts_gt [5, F, 3])."""
    from coslam_torch.io.synthetic import make_room, render_batch, rig_sequence
    rng = np.random.default_rng(0)
    rng.uniform()
    planes = make_room(rng, size=10.0)
    C = 5
    Rs, ts = rig_sequence(C, n_frames, baseline=0.8, forward=0.04)
    frames = render_batch(planes, KPROD,
                          Rs.transpose(1, 0, 2, 3).reshape(-1, 3, 3),
                          ts.transpose(1, 0, 2).reshape(-1, 3), H, W,
                          frames=np.repeat(np.arange(n_frames), C),
                          chunk=4 * C, device=dev).reshape(n_frames, C, H, W)
    return frames.half().float(), Rs, ts


def step_contract(mesh) -> dict:
    """The transfers of one mesh step (tests/test_torch_parallel.py::
    test_step_transfer_census): each shard's 11 track rows there and back,
    and its NCC block pair back."""
    from coslam_torch.slam.state import TrackTable
    n = len(mesh)
    want = {("to_main", "ncc.blocks"): n, ("to_main", "ncc.ok"): n}
    for name in TrackTable._fields:
        want[("to_shard", f"tracks.{name}")] = n
        want[("to_main", f"tracks.{name}")] = n
    return want


class StepCensus:
    """While entered, the mesh's transfers during each call of
    ``fused.frame_step`` (also inside ``frame_steps_scan``), one dict a
    call in ``steps``."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.steps = []

    def __enter__(self):
        import coslam_torch.slam.fused as fused
        import coslam_torch.slam.pipeline as pipeline
        self._mods = (fused, pipeline)
        self._orig = fused.frame_step
        census = self

        def counted(*args, **kw):
            before = dict(census.mesh.census)
            out = census._orig(*args, **kw)
            after = census.mesh.census
            census.steps.append({k: v - before.get(k, 0)
                                 for k, v in after.items()
                                 if v != before.get(k, 0)})
            return out
        for m in self._mods:
            m.frame_step = counted
        return self

    def __exit__(self, *exc):
        for m in self._mods:
            m.frame_step = self._orig


def phase_mesh_small_agreement(one):
    """The two-camera engine on a mesh (one camera a shard, over
    mesh_devices) against the same engine on one card (``one``: the card's
    run of phase_multicam_small_agreement), on that phase's 20-frame rig
    and in its band (agreement(): the same bootstrap frame and groups,
    keyframes one entry apart, centres within 5% of the path RMS, ATE
    under 0.25). Both sum on the card, in an order that changes from run
    to run."""
    from coslam_torch.parallel.mesh import make_cam_mesh
    cfg, K, frames, Rs_gt, ts_gt = two_camera_inputs()
    mesh = make_cam_mesh(devices=mesh_devices(cfg.num_cameras))
    sharded, _, launched = run_engine(cfg, K, frames, "cuda", mesh=mesh)
    log(f"mesh small input: mesh {mesh}; census {mesh_census_log(mesh)}")
    agreement(one, sharded, Rs_gt, ts_gt, 0.25, "mesh small input")
    check("mesh small input", {
        "bootstrap at frame 0": boot_frame(one) == boot_frame(sharded) == 0,
        **launch_checks(launched, search=False)})


def mesh_census_log(mesh) -> dict:
    return {f"{d}:{leaf}": v for (d, leaf), v in sorted(mesh.census.items())}


def phase_fivecam_mesh(card: str):
    """fivecam_mesh (BASELINE config 5, examples/accuracy_bench.py:292-322)
    at the production configuration: five cameras on a rig, 60 of its 150
    frames, the chunked engine (chunk=6) on a mesh of one camera a shard
    over mesh_devices, the frames copied from the host straight to their
    shards. The wide-baseline bootstrap by frame 2, one group, every
    camera's ATE under 2% of camera 0's path (the JAX package's record:
    0.46%, ACCURACY.md:23), finite poses and map; build_pyramid on every
    frame and klt_track on every frame after the first, once a shard,
    ncc_blocks on every shard of every tracked frame after the bootstrap,
    ncc_search and extract_windows never; each mesh step's transfers
    exactly the step contract (step_contract); no synchronizing call
    inside frame_step. Logged: the bootstrap frame, the wall per tracked
    frame (each chunk call ends in a device sync, its wall shared by its
    frames), synchronizing calls, peak memory per card."""
    import contextlib
    from coslam_torch.io.ate import ate_rmse, camera_centers
    from coslam_torch.parallel.mesh import make_cam_mesh
    from coslam_torch.slam.pipeline import CoSlamEngine
    n, C = MESH_FRAMES, 5
    t0 = time.perf_counter()
    frames, Rs_gt, ts_gt = fivecam_scene(n, "cuda")
    frames = frames.cpu()
    log(f"fivecam_mesh: rendered {tuple(frames.shape)} in "
        f"{time.perf_counter() - t0:.2f} s")
    devs = mesh_devices(C)
    mesh = make_cam_mesh(devices=devs)
    log(f"fivecam_mesh: mesh {mesh} ({len(set(devs))} distinct card(s))")
    cfg = production_cfg(C)
    K = np.repeat(KPROD[None], C, 0)
    eng = CoSlamEngine(cfg, K, np.zeros((C, 5), np.float32), device=devs[0],
                       chunk=MESH_CHUNK, mesh=mesh)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    held = reset_peak_memory()
    calls = []                  # (wall ms, frames the call stepped)
    t_run = time.perf_counter()
    with SyncCounter() as syncs, StepCensus(mesh) as steps:
        for f in range(n):
            n0 = len(steps.steps)
            t0 = time.perf_counter()
            eng.process_frame(frames[f])
            torch.cuda.synchronize()
            calls.append(((time.perf_counter() - t0) * 1e3,
                          len(steps.steps) - n0))
        trajs = [eng.trajectory(c, correct=True) for c in range(C)]
    run_s = time.perf_counter() - t_run
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = peak_memory_mib()
    ids, xyz, cov = eng.map_points()
    path = float(np.linalg.norm(np.diff(camera_centers(Rs_gt[0], ts_gt[0]),
                                        axis=0), axis=-1).sum())
    ates = [ate_rmse(*trajs[c], Rs_gt[c], ts_gt[c]) for c in range(C)]
    boot = boot_frame(eng)
    per_frame = [ms / k for ms, k in calls if k]
    n_steps = len(steps.steps)
    want = step_contract(mesh)
    bad_steps = [i for i, d in enumerate(steps.steps) if d != want]
    n_trk = sum("med_err" in s for s in eng.stats_log)
    log(f"fivecam_mesh: bootstrap {boot} keyframes {eng.kf_frames} "
        f"ba_runs {eng.ba_runs} map_points {len(ids)} groups "
        f"{eng.group_id.tolist()}")
    log(f"fivecam_mesh: ATE per camera {[round(a, 6) for a in ates]} over a "
        f"{path:.4f} camera-0 path "
        f"({[round(100 * a / path, 4) for a in ates]}%)")
    log(f"fivecam_mesh: wall per tracked frame (chunk calls of "
        f"{MESH_CHUNK}, each ending in a sync) median "
        f"{float(np.median(per_frame)):.3f} ms, p90 "
        f"{float(np.percentile(per_frame, 90)):.3f} ms over {n_steps} mesh "
        f"steps; total {run_s:.2f} s; card {card}")
    log(f"fivecam_mesh: {syncs.total} synchronizing calls over {n_trk} "
        f"tracked frames ({syncs.total / max(n_trk, 1):.3f} a tracked "
        f"frame), {syncs.in_step} inside frame_step, explicit "
        f"torch.cuda.synchronize {syncs.explicit_syncs} "
        f"({syncs.explicit_syncs / max(n_trk, 1):.3f} a tracked frame)")
    log(f"fivecam_mesh: kernel launches {launches}; peak device memory "
        f"{peak} MiB (held at its start {held}); card {card}")
    log(f"fivecam_mesh: transfers of each mesh step {want} "
        f"({sum(want.values())}); steps off the contract {len(bad_steps)}; "
        f"the run's census {mesh_census_log(mesh)}")
    n_fused = n - 1 - (boot or 0)
    check("fivecam_mesh", {
        "bootstrap by frame 2": boot is not None and boot <= 2,
        "one group": len(set(eng.group_id.tolist())) == 1,
        "every camera's ATE < 2% of the camera-0 path":
            max(ates) < 0.02 * path,
        "finite poses": all(np.isfinite(R).all() and np.isfinite(t).all()
                            for R, t in trajs),
        "finite map": bool(len(ids) > 0 and np.isfinite(xyz).all()
                           and np.isfinite(cov).all()),
        "build_pyramid once a shard every frame":
            launches["build_pyramid"] == C * n,
        "klt_track once a shard every frame after the first":
            launches["klt_track"] == C * (n - 1),
        "ncc_blocks on every shard of every tracked frame":
            launches["ncc_blocks"] >= C * n_fused,
        "ncc_search not launched": launches["ncc_search"] == 0,
        "extract_windows not launched": launches["extract_windows"] == 0,
        "every tracked frame a mesh step": n_steps == n_fused,
        "each mesh step's transfers the contract": not bad_steps,
        "frame_step never waits on the host": syncs.in_step == 0,
    })
    return launches


def bench_ba_problem(n_shards: int, dev):
    """bench.py's BA problem (bench.py:129-172: 15 cameras, 2048 points,
    ~3 observations a point, 0.3 px noise), drawn from seed 0, its point
    axis padded to a multiple of ``n_shards`` with points of no
    observation, frozen. Returns (BATableProblem on ``dev``, the mask of
    the real points seen at least twice)."""
    from coslam_torch.geometry.se3 import so3_exp_np
    from coslam_torch.solvers.ba import BATableProblem
    rng = np.random.default_rng(0)
    M, P = 15, 2048
    pad = (-P) % n_shards
    X = rng.uniform(-4, 4, (P, 3)).astype(np.float32)
    X[:, 2] += 10
    Rb = np.stack([so3_exp_np(0.05 * rng.standard_normal(3).astype(
        np.float32)) for _ in range(M)]).astype(np.float32)
    tb = np.stack([np.array([0.2 * m, 0, 0.05], np.float32)
                   for m in range(M)])
    valid = rng.random((M, P)) < (3.0 / M)
    px = np.zeros((M, 2, P), np.float32)
    f, cx, cy = KPROD[0, 0], KPROD[0, 2], KPROD[1, 2]
    for s in range(M):
        Xc = X @ Rb[s].T + tb[s]
        px[s, 0] = Xc[:, 0] / Xc[:, 2] * f + cx
        px[s, 1] = Xc[:, 1] / Xc[:, 2] * f + cy
    px += 0.3 * rng.standard_normal(px.shape).astype(np.float32)
    cam_fixed = np.zeros(M, bool)
    cam_fixed[:2] = True
    X0 = np.concatenate([X + 0.05, np.tile(np.float32([0, 0, 10]),
                                           (pad, 1))]).astype(np.float32)
    px = np.concatenate([px, np.zeros((M, 2, pad), np.float32)], axis=2)
    valid_p = np.concatenate([valid, np.zeros((M, pad), bool)], axis=1)
    fixed = np.concatenate([np.zeros(P, bool), np.ones(pad, bool)])

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    prob = BATableProblem(K=T(np.broadcast_to(KPROD, (M, 3, 3))), R=T(Rb),
                          t=T(tb), X=T(X0), obs_px=T(px),
                          obs_valid=T(valid_p), cam_fixed=T(cam_fixed),
                          point_fixed=T(fixed))
    return prob, valid.sum(0) >= 2


def phase_parallel(card: str, mono_frames):
    """The multi-device layer's records on the card's devices:
    - run_dryrun(5) at 480x640 with 1024 features (one mesh step, both
      distributed BAs);
    - dist_bundle_adjust_table over 5 point shards (mesh_devices) against
      bundle_adjust_table on one card on bench.py's problem, R and t within
      5e-4 and X within 5e-3 (points seen twice or more), both timed (CUDA
      events around one solve, median of BA_REPS) as LM iterations/s;
    - async BA on another device than the engine's: the mono scene's 100
      frames (the main path's bound, 2% of the path, is set over all of
      them: over the first 40 the same engine on the CPU reaches 4.80% of
      that shorter path, with or without async BA), the solves on cuda:1
      if the machine has it, else on the CPU; every dispatched BA applied,
      the ATE under 2% of the path."""
    from coslam_torch.io.ate import ate_rmse, camera_centers
    from coslam_torch.io.synthetic import orbit_trajectory
    from coslam_torch.parallel.dist_ba import dist_bundle_adjust_table
    from coslam_torch.parallel.dryrun import run_dryrun
    from coslam_torch.parallel.mesh import make_cam_mesh
    from coslam_torch.solvers.ba import bundle_adjust_table
    n = 5
    t0 = time.perf_counter()
    dry = run_dryrun(n, h=H, w=W, feats=N_FEAT, verbose=False,
                     devices=mesh_devices(n))
    log(f"parallel: run_dryrun({n}) at {H}x{W}, {N_FEAT} features on "
        f"{mesh_devices(n)}: {json.dumps(dry)} in "
        f"{time.perf_counter() - t0:.2f} s")
    mesh = make_cam_mesh(devices=mesh_devices(n))
    prob, seen = bench_ba_problem(n, mesh.main)
    kw = dict(max_err=10.0, max_iter=2, inner_iter=30)
    iters = kw["max_iter"] * kw["inner_iter"]

    def timed(fn):
        out = fn()
        ms = []
        for _ in range(BA_REPS):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn()
            e.record()
            e.synchronize()
            ms.append(s.elapsed_time(e))
        return out, float(np.median(ms))
    one, one_ms = timed(lambda: bundle_adjust_table(prob, **kw))
    dist, dist_ms = timed(lambda: dist_bundle_adjust_table(prob, mesh, **kw))
    P = seen.shape[0]
    seen = torch.from_numpy(seen).to(mesh.main)
    d_R = float((one.R - dist.R).abs().max())
    d_t = float((one.t - dist.t).abs().max())
    d_X = float((one.X[:P][seen] - dist.X[:P][seen]).abs().max())
    d_X_all = float((one.X[:P] - dist.X[:P]).abs().max())
    log(f"parallel: table BA on bench.py's problem (15 cameras x 2048 "
        f"points, {int(prob.obs_valid.sum())} observations): one card "
        f"{one_ms:.3f} ms a solve ({iters / one_ms * 1e3:.1f} LM iterations/"
        f"s), {n} point shards on {mesh_devices(n)} {dist_ms:.3f} ms "
        f"({iters / dist_ms * 1e3:.1f} LM iterations/s); cost "
        f"{float(one.cost):.4f} and {float(dist.cost):.4f}; apart: R "
        f"{d_R:.3e}, t {d_t:.3e}, X {d_X:.3e} (seen twice or more; all "
        f"{d_X_all:.3e}); card {card}")
    # async BA on another device
    other = "cuda:1" if torch.cuda.device_count() > 1 else "cpu"
    nf = mono_frames.shape[0]
    cfg = production_cfg(1)
    Rs_gt, ts_gt = orbit_trajectory(FRAMES, forward=0.04)
    eng, frame_ms, _ = run_engine(cfg, KPROD[None], mono_frames, "cuda",
                                  async_ba=True, ba_device=other)
    eng._apply_pending_ba()
    Rs, ts = eng.trajectory(0, correct=True)
    c_gt = camera_centers(Rs_gt[:nf], ts_gt[:nf])
    path = float(np.linalg.norm(np.diff(c_gt, axis=0), axis=-1).sum())
    ate = ate_rmse(Rs, ts, Rs_gt[:nf], ts_gt[:nf])
    ba = eng.ba_async
    log(f"parallel: async BA on {other} (engine on the card), mono {nf} "
        f"frames: BA {ba}; ATE {ate:.6f} over a {path:.4f} path "
        f"({100 * ate / path:.4f}%); tracked-frame median "
        f"{frame_times(eng, frame_ms)[1]:.3f} ms; card {card}")
    check("parallel", {
        "dry run": len(dry["n_tracked"]) == n and min(dry["n_tracked"]) > 0,
        "distributed BA: R within 5e-4": d_R <= 5e-4,
        "distributed BA: t within 5e-4": d_t <= 5e-4,
        "distributed BA: X within 5e-3": d_X <= 5e-3,
        "distributed BA: finite cost": bool(torch.isfinite(dist.cost)),
        ">= 1 BA dispatched to the other device": ba["dispatched"] >= 1,
        "every BA applied": eng._pending_ba is None
        and ba["dispatched"] == ba["ready"] + ba["deferred"]
        + ba["flushed"] + ba["cancelled"] and ba["cancelled"] == 0,
        "ATE < 2% of path": ate < 0.02 * path,
    })


ACC_KEYS = ("config", "cams", "frames", "shape", "ate", "ate_max",
            "ate_pct_path", "path_len", "fps", "n_merges", "merges_noop",
            "n_loops", "n_keyframes", "eval_from")
SYNTHETIC_ATE = 0.20             # run_synthetic's own bound


def phase_accuracy_harness(card: str):
    """The port's accuracy harness in-process
    (``coslam_torch.examples.accuracy_bench``): config_occlusion at its full
    300 frames, 480x640, seed 7, through the harness's chunked engine
    (chunk=6, the frames staged as float16 on the card). Camera 1's lens is
    covered over frames f0..f1 (75..135). Checked: every row key present
    and finite; camera 1 in another group than camera 0 somewhere in frames
    f0+10..f1+10 (tests/test_occlusion.py); a merge with ``noop`` False at
    a frame >= f1; one group at the end; the max ATE scored from f1+20
    under 2% of camera 0's path; the path's kernels launched. Then
    run_synthetic's ``main()`` on the card (return code 0, ATE under
    0.20), and visualize_results on an export of the occlusion run: a PLY
    whose vertex count is the map points plus 8 (F - 1) a camera. Returns
    the occlusion run's kernel launches."""
    import contextlib
    import io
    import re
    import tempfile
    from coslam_torch.examples import (accuracy_bench, run_synthetic,
                                       visualize_results)
    from coslam_torch.io.export import export_results
    F = accuracy_bench.DEFAULT_FRAMES["occlusion"]
    f0, f1 = int(F * 0.25), int(F * 0.45)
    engines = {}
    held = reset_peak_memory()
    t0 = time.perf_counter()
    row = accuracy_bench.config_occlusion(
        F, np.random.default_rng(accuracy_bench.SEED), engines=engines)
    log(f"accuracy_harness: occlusion {F} frames in "
        f"{time.perf_counter() - t0:.2f} s (the render included)")
    eng = engines.pop("occlusion")
    gh = eng.group_hist
    trans = [(i, g) for i, g in enumerate(gh) if i and g != gh[i - 1]]
    numbers = [row[k] for k in ("ate_max", "ate_pct_path", "path_len",
                                "fps", "peak_mem_mib")] + row["ate"]
    log(f"accuracy_harness: row {json.dumps(row)}")
    log(f"accuracy_harness: group transitions {trans}")
    log("accuracy_harness: merge_log " + json.dumps([
        {k: (round(v, 6) if isinstance(v, float) else v)
         for k, v in m.items()} for m in eng.merge_log]))
    log(f"accuracy_harness: wall {1e3 / row['fps']:.3f} ms a frame "
        f"(chunk=6, one sync at the end); peak device memory "
        f"{row['peak_mem_mib']} MiB (held at the phase's start {held}); "
        f"kernel launches {row['launches']}; card {card}")
    checks = {
        "every row key present and finite":
            all(k in row for k in ACC_KEYS)
            and bool(np.isfinite(np.asarray(numbers, float)).all()),
        "camera 1 in another group during the blackout":
            any(g[0] != g[1] for g in gh[f0 + 10:f1 + 10]),
        "a realigning merge (noop False) at frame >= f1":
            any(not m.get("noop") and m["frame"] >= f1
                for m in eng.merge_log),
        "one group at the end": gh[-1][0] == gh[-1][1],
        "max ATE from f1+20 < 2% of camera 0's path":
            row["ate_max"] < 0.02 * row["path_len"],
        **launch_checks(row["launches"], search=False),
    }
    # the synthetic smoke run, on the card
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = run_synthetic.main([])
    found = re.search(r"ATE: ([0-9.]+)", out.getvalue())
    ate = float(found.group(1)) if found else float("nan")
    log(f"accuracy_harness: run_synthetic rc {rc}, ATE {ate} in "
        f"{time.perf_counter() - t0:.2f} s")
    checks["run_synthetic: return code 0"] = rc == 0
    checks[f"run_synthetic: ATE < {SYNTHETIC_ATE}"] = ate < SYNTHETIC_ATE
    # the viewer, on an export of the occlusion run
    with tempfile.TemporaryDirectory() as root:
        export_results(root, eng)
        ids, _, _ = eng.map_points()
        written = visualize_results.main([root])
        with open(written[0]) as fh:
            header = fh.read(400)
    found = re.search(r"element vertex (\d+)", header)
    n_vert = int(found.group(1)) if found else -1
    want = len(ids) + visualize_results.DENSIFY * (F - 1) * row["cams"]
    log(f"accuracy_harness: visualize_results wrote "
        f"{[os.path.basename(w) for w in written]}, {n_vert} PLY vertices "
        f"({len(ids)} map points + {visualize_results.DENSIFY} x {F - 1} "
        f"a camera)")
    checks["PLY vertices: map points + 8 (F - 1) a camera"] = n_vert == want
    del eng, engines
    check("accuracy_harness", checks)
    return row["launches"]


def finite_numbers(tree) -> bool:
    """Every number in a tool's returned tree is finite (None counts: a
    share with no positive delta; names are skipped)."""
    if isinstance(tree, str):
        return True
    if isinstance(tree, dict):
        return all(finite_numbers(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(finite_numbers(v) for v in tree)
    return tree is None or bool(np.isfinite(tree))


def phase_timing_tools(card: str):
    """The four timing tools on the card through their ``main``, at the
    bench shapes: profile_ba at ``--iters 3`` (five solves of 2 x 30 LM
    iterations), profile_stages at ``--iters 3``, profile_engine over 26
    frames fed from the host and again resident, profile_ablate at
    ``--iters 3``.
    Checked: every returned number finite; profile_stages' build_pyramid,
    advance_tracks and new_map_points stages launched build_pyramid,
    klt_track and ncc_blocks at least once a call; the stage, ablation and
    engine tools each launched build_pyramid, klt_track and ncc_blocks
    (none fell back to a plain version). Logs every returned number.
    Returns the phase's kernel launches."""
    import contextlib
    import io
    from coslam_torch.examples import (profile_ablate, profile_ba,
                                       profile_engine, profile_stages)
    counters = kernel_counters()
    # profile_ablate last: the first launches after a torch.profiler run
    # are slower (on the H100, profile_ba's normal terms took 51 ms a call
    # right after profile_ablate, 4.8 ms on its next run), so no tool's
    # window follows one
    runs = {"profile_ba": (profile_ba, ["--iters", "3"]),
            "profile_stages": (profile_stages, ["--iters", "3"]),
            "profile_engine": (profile_engine, ["--frames", "26"]),
            "profile_engine --resident": (
                profile_engine, ["--frames", "26", "--resident"]),
            "profile_ablate": (profile_ablate, ["--iters", "3"])}
    need = ("build_pyramid", "klt_track", "ncc_blocks")
    results, checks = {}, {}
    for name, (tool, argv) in runs.items():
        before = {k: fn.launches for k, fn in counters.items()}
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = tool.main(argv)
        secs = time.perf_counter() - t0
        launched = {k: fn.launches - before[k] for k, fn in counters.items()}
        results[name] = res
        for line in out.getvalue().splitlines():
            log(f"timing_tools: {name}: {line}")
        log(f"timing_tools: {name} returned {json.dumps(res)}")
        log(f"timing_tools: {name}: {secs:.2f} s, kernel launches "
            f"{launched}; card {card}")
        checks[f"{name}: every number finite"] = finite_numbers(res)
        if name != "profile_ba":        # the BA runs no hand-written kernel
            checks[f"{name}: no plain fallback"] = all(
                launched[k] > 0 for k in need)
    per_call = results["profile_stages"]["launches"]
    for stage, kernel in (("build_pyramid", "build_pyramid"),
                          ("advance_tracks (KLT)", "klt_track"),
                          ("new_map_points", "ncc_blocks")):
        checks[f"profile_stages: {stage} launched {kernel}"] = \
            per_call[stage][kernel] >= 1
    check("timing_tools", checks)
    return {k: fn.launches for k, fn in counters.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile-table", default=None,
                    help="write the profiler's operator tables here")
    ap.add_argument("--syncs-only", action="store_true",
                    help="only count the default mono engine's "
                    "synchronizing calls over 40 frames (runs against an "
                    "older version of the package beside this script)")
    args = ap.parse_args()
    if args.syncs_only:
        _, _, smi = phase_device()
        phase_build()
        phase_syncs(smi)
        return
    t_start = t_lap = time.perf_counter()

    def lap(phase: str):
        """Log the wall time of the phase that just ended."""
        nonlocal t_lap
        now = time.perf_counter()
        log(f"phase {phase}: {now - t_lap:.2f} s wall")
        t_lap = now
    name, count, smi = phase_device()
    # the CPU side of the card-against-CPU agreements, made meanwhile by
    # one worker process (spawned: this process holds CUDA)
    pool = ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu_runs = {k: pool.submit(cpu_run, k) for k in CPU_RUNS}
        per_shape, by_path = run_phases(smi, cpu_runs, args, lap)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    report(name, count, smi, per_shape, by_path, t_start)


def run_phases(smi: str, cpu_runs: dict, args, lap):
    """Every phase after the device check, in order. Returns the kernel
    records of each shape and the launches of each path."""
    phase_build()
    lap("build")
    per_shape = phase_kernels()
    lap("kernels")
    phase_small_agreement(cpu_runs)
    lap("small agreement")
    mono, (snap, frames), n_kf = phase_main_path(smi)
    mono_frames = frames
    lap("mono")
    phase_profile(snap, frames, PROFILE_WARM[0], smi, args.profile_table,
                  label="mono")
    del snap
    lap("mono profile")
    modes = phase_modes(smi, frames, n_kf)
    lap("modes")
    phase_non_fused_small_agreement(cpu_runs)
    lap("non-fused small agreement")
    two_camera = phase_multicam_small_agreement(cpu_runs)
    lap("two-camera small agreement")
    multi, (snap, frames) = phase_multicam_path(smi)
    lap("threecam_dyn")
    phase_profile(snap, frames, PROFILE_WARM[1], smi,
                  args.profile_table and args.profile_table + ".threecam",
                  label="threecam_dyn")
    del snap
    lap("threecam_dyn profile")
    phase_loop_small_agreement(cpu_runs)
    lap("loop small agreement")
    split, eng, frames, f0 = phase_splitmerge_path(smi)
    lap("splitmerge")
    phase_profile(eng, frames, f0, smi, args.profile_table and
                  args.profile_table + ".splitmerge", label="splitmerge")
    del eng, frames             # ~1 GB the later phases' peaks would hold
    lap("splitmerge profile")
    loop = phase_mono_loop_path(smi)
    lap("mono_loop")
    dist = phase_distorted_io(smi)
    lap("distorted_io")
    phase_mesh_small_agreement(two_camera)
    del two_camera
    lap("mesh small agreement")
    fivecam = phase_fivecam_mesh(smi)
    lap("fivecam_mesh")
    phase_parallel(smi, mono_frames)
    lap("parallel")
    harness = phase_accuracy_harness(smi)
    lap("accuracy_harness")
    for fn in kernel_counters().values():
        fn.launches = 0
    tools = phase_timing_tools(smi)
    lap("timing_tools")
    by_path = {"mono": mono, "modes": modes, "threecam_dyn": multi,
               "splitmerge": split, "mono_loop": loop, "distorted_io": dist,
               "fivecam_mesh": fivecam, "accuracy_harness": harness,
               "timing_tools": tools}
    return per_shape, by_path


def report(name, count, smi, per_shape, by_path, t_start):
    """The per-kernel JSON record, then the last line."""
    general = per_shape.pop("general_radius")
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
        "ncc_blocks": dict(
            route="cuda", source="coslam_torch/csrc/ncc_blocks.cu",
            replaces=f"{repo}/ops/patches.py:198"),
        "ncc_search": dict(
            route="cuda", source="coslam_torch/csrc/ncc_search.cu",
            replaces=f"{repo}/ops/patches.py:198"),
    }
    kernels = []
    for kname, recs in per_shape.items():
        head = recs[0]          # the three-camera path's shape
        rec = dict(
            name=kname, **meta[kname],
            launches=sum(p[kname] for p in by_path.values()),
            launches_by_path={p: c[kname] for p, c in by_path.items()},
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape=head["shape"])
        for k in ("eager_ms", "turns_ms", "activities", "activity_names",
                  "plain_activities", "conv_ms"):
            if k in head:
                rec[k] = head[k]
        if kname == "ncc_blocks":
            rec["one_camera"] = {k: recs[1][k] for k in (
                "shape", "max_abs_err", "ms", "eager_ms", "plain_ms",
                "bound_ms", "activities", "plain_activities")}
        if kname in general:
            rec["general_radius"] = {k: general[kname][k] for k in (
                "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by")}
        if kname == "extract_windows":
            loop_rec = recs[-1]     # the loop closure's G = 43 search
            rec["loop_search"] = {k: loop_rec[k] for k in (
                "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}
        kernels.append(rec)
    log(f"total wall time {time.perf_counter() - t_start:.2f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
