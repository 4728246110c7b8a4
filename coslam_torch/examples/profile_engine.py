"""Per-stage wall-clock profile of the engine loop (the port of
``examples/profile_engine.py``).

Renders the bench engine scene (3 cameras on a rig, 480x640, the room on
an orbit at forward 0.05, seed 0) on the engine's device, clipped to
uint8, and runs ``CoSlamEngine`` at the bench configuration: 20 warm
frames, then the stage clock (``eng.timing``) is reset and the rest are
timed. Prints the steady frames/s (a window closed by a
``torch.cuda.synchronize()``), the stage clock in ms a frame, median, p90
and max of the per-frame walls and the eight slowest frames.

The per-frame walls are ``process_frame``'s own, as in the reference:
with ``--chunk`` or ``--overlap`` they are the times to queue a frame's
work, and the card's execution lands in the frames that wait. The frames
are fed from host uint8 arrays, or with ``--resident`` staged on the card
before the loop (and waited for). No frame cache is written. The
reference's ``fuse_close_points`` pre-warm warms a compile cache and has
no counterpart here.

    python -m coslam_torch.examples.profile_engine [--overlap] [--chunk N]
        [--frames 64] [--resident] [--cpu]

Runs on the CUDA card unless given ``--cpu``; raises without a card
otherwise. The first line names the card and its power limit (nvidia-smi)
or ``cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from coslam_torch.examples.profile_stages import bench_config, sync
from coslam_torch.util import resolve_device

WARM = 20


def scene(F: int, C: int = 3, H: int = 480, W: int = 640, device=None):
    """The bench engine scene: (frames [F, C, H, W] uint8 on ``device``,
    K [C, 3, 3] numpy), the generator drawn as the reference's render."""
    from coslam_torch.io.synthetic import (make_room, multi_cam_rig,
                                           orbit_trajectory, render_batch)
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    Kb = np.broadcast_to(
        np.array([[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1]],
                 np.float32), (C, 3, 3)).copy()
    planes = make_room(rng, size=10.0)
    Rr, tr = orbit_trajectory(F, forward=0.05)
    rot_c, offs_c = multi_cam_rig(C, baseline=1.0)
    Rs = np.zeros((F, C, 3, 3), np.float32)
    ts = np.zeros((F, C, 3), np.float32)
    for f in range(F):
        c_rig = -Rr[f].T @ tr[f]
        for c in range(C):
            center = c_rig + Rr[f].T @ offs_c[c]
            Rs[f, c] = rot_c[c] @ Rr[f]
            ts[f, c] = -Rs[f, c] @ center
    frames = render_batch(planes, Kb[0], Rs.reshape(-1, 3, 3),
                          ts.reshape(-1, 3), H, W, device=dev)
    frames = torch.clamp(frames, 0, 255).to(torch.uint8)
    return frames.reshape(F, C, H, W), Kb


def run(frames: int = 64, overlap: bool = False, chunk: int = 1,
        resident: bool = False, C: int = 3, H: int = 480, W: int = 640,
        cfg=None, device=None) -> dict:
    """Drive the engine; print the reference's lines. ``cfg`` defaults to
    the bench configuration. Returns {"fps", "ms_per_frame", "timing"
    (ms a frame by stage), "per_frame_ms" (the timed frames' walls),
    "median_ms", "p90_ms", "max_ms", "slowest" [(frame, ms)]}."""
    from coslam_torch.slam.pipeline import CoSlamEngine
    dev = resolve_device(device)
    F = frames
    imgs, Kb = scene(F, C, H, W, dev)
    if resident:
        seq = list(imgs)
        sync(dev)                                 # wait for staging
    else:
        seq = list(imgs.cpu().numpy())
    cfg = bench_config(C, H, W) if cfg is None else cfg
    kw = {"chunk": chunk} if chunk > 1 else {}
    eng = CoSlamEngine(cfg, Kb, np.zeros((C, 5), np.float32), device=dev,
                       overlap=overlap, **kw)
    for f in range(WARM):
        eng.process_frame(seq[f])
    sync(dev)
    eng.timing = {}
    per_frame = []
    t_all0 = time.perf_counter()
    for f in range(WARM, F):
        t0 = time.perf_counter()
        eng.process_frame(seq[f])
        per_frame.append(time.perf_counter() - t0)
    sync(dev)
    dt = time.perf_counter() - t_all0
    n = F - WARM
    print(f"steady fps: {n / dt:.2f}  ({1e3 * dt / n:.1f} ms/frame)")
    print("timing (ms/frame):")
    timing = {k: 1e3 * v / n for k, v in
              sorted(eng.timing.items(), key=lambda kv: -kv[1])}
    for k, v in timing.items():
        print(f"  {k:20s} {v:8.2f}")
    pf = np.array(per_frame) * 1e3
    print(f"per-frame ms: med={np.median(pf):.1f} "
          f"p90={np.percentile(pf, 90):.1f} max={pf.max():.1f}")
    hi = np.argsort(pf)[-8:]
    slowest = [(int(i) + WARM, round(float(pf[i]), 1)) for i in sorted(hi)]
    print("slowest frames:", slowest)
    return {"fps": n / dt, "ms_per_frame": 1e3 * dt / n, "timing": timing,
            "per_frame_ms": pf.tolist(), "median_ms": float(np.median(pf)),
            "p90_ms": float(np.percentile(pf, 90)), "max_ms": float(pf.max()),
            "slowest": slowest}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--chunk", type=int, default=1)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--resident", action="store_true",
                    help="stage the frames in device memory before the "
                         "loop (else the engine is fed host uint8 arrays)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from coslam_torch.examples.accuracy_bench import device_label
    device = "cpu" if args.cpu else None
    print(device_label(device), flush=True)        # raises without a card
    return run(frames=args.frames, overlap=args.overlap, chunk=args.chunk,
               resident=args.resident, device=device)


if __name__ == "__main__":
    main()
