"""Run the full pipeline on a synthetic room sequence and print ATE (the
port of ``examples/run_synthetic.py``).

    python -m coslam_torch.examples.run_synthetic [--frames 60] [--cpu]

Renders 150x200 frames of the textured room on the engine's device (the
CUDA card; ``--cpu``: the CPU), drives the one-camera engine at
``small_test_config(1)`` and exits 0 when the corrected trajectory's ATE
is under 0.20 and the map is finite, 1 otherwise.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

ATE_BOUND = 0.20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from coslam_torch.config import small_test_config
    from coslam_torch.io.ate import ate_rmse
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence)
    from coslam_torch.slam.pipeline import CoSlamEngine
    from coslam_torch.util import resolve_device
    dev = resolve_device("cpu" if args.cpu else None)

    rng = np.random.default_rng(0)
    H, W = 150, 200
    cfg = small_test_config(num_cameras=1, h=H, w=W)
    K = np.array([[[180.0, 0, 100], [0, 180.0, 75], [0, 0, 1]]],
                 dtype=np.float32)
    kc = np.zeros((1, 5), dtype=np.float32)
    planes = make_room(rng, size=10.0)
    Rs_gt, ts_gt = orbit_trajectory(args.frames, forward=0.06)
    print(f"rendering on {dev}...", flush=True)
    frames = render_sequence(planes, K[0], Rs_gt, ts_gt, H, W, device=dev)
    eng = CoSlamEngine(cfg, K, kc, device=dev)
    t0 = time.time()
    for f in range(args.frames):
        s = eng.process_frame(frames[f][None])
        if f % 20 == 0:
            print(f"frame {f}: inliers={s['n_inliers']}", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    Rs, ts = eng.trajectory(0, correct=True)
    ate = ate_rmse(Rs, ts, Rs_gt, ts_gt)
    ids, xyz, _ = eng.map_points()
    print(f"frames: {args.frames}  time: {dt:.1f}s  "
          f"({args.frames / dt:.1f} fps incl. kernel builds)")
    print(f"map points: {len(ids)}  keyframes: {len(eng.kf_frames)}")
    print(f"ATE: {ate:.4f} m (bound: {ATE_BOUND:.2f})")
    ok = ate < ATE_BOUND and np.isfinite(xyz).all()
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
