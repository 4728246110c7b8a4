"""Run collaborative SLAM on real inputs, reference-CLI compatible (the
port of ``examples/run_coslam.py``, option for option).

    python -m coslam_torch.cli <input.txt> [--out DIR] [--frames N] [--cpu]
                               [--small]

<input.txt> uses the reference's format (videos + calibration files,
README.md:91-116). Videos other than CSRW files (``.csrw``/``.raw``) are
decoded to raw grayscale through cv2 on first use (cached beside the
video); the native threaded loader then feeds the engine, which runs on
the CUDA card (``--cpu``: on the CPU). Results are exported in the
reference's output format (mappts.txt, <c>_campose.txt, <c>_featpts.txt,
input_videos.txt).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    """Parse, decode, load, run, export. Returns the engine after the run."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input")
    ap.add_argument("--out", default=None)
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="tiny capacities (smoke tests)")
    args = ap.parse_args(argv)
    from coslam_torch.config import SlamConfig, small_test_config
    from coslam_torch.io.calib import parse_input_file, read_calib_file
    from coslam_torch.io.export import export_results
    from coslam_torch.io.loader import (MODE_RAW, FrameLoader,
                                        convert_video_to_raw)
    from coslam_torch.slam.pipeline import CoSlamEngine

    spec = parse_input_file(args.input)
    C = spec.num_views
    Ks, kcs = zip(*(read_calib_file(p) for p in spec.calib_paths))
    # decode videos to raw once (cached next to the video)
    raw_paths = []
    for v in spec.video_paths:
        if v.endswith(".csrw") or v.endswith(".raw"):
            raw_paths.append(v)
            continue
        rp = v + ".csrw"
        if not os.path.exists(rp):
            print(f"decoding {v} ...", flush=True)
            convert_video_to_raw(v, rp)
        raw_paths.append(rp)
    loader = FrameLoader(raw_paths, mode=MODE_RAW,
                         start_frames=spec.skip_frames)
    h, w = loader.hw
    if args.small:
        cfg = small_test_config(num_cameras=C, h=h, w=w)
    else:
        cfg = SlamConfig(num_cameras=C, image_height=h, image_width=w)
    eng = CoSlamEngine(cfg, np.stack(Ks), np.stack(kcs),
                       device="cpu" if args.cpu else None)
    t0 = time.time()
    n = 0
    try:
        for frames in loader:
            stats = eng.process_frame(frames)
            n += 1
            if n % 25 == 0:
                print(f"f:{n}  inliers={stats['n_inliers']}", flush=True)
            if args.frames and n >= args.frames:
                break
    finally:
        loader.close()
    dt = time.time() - t0
    print(f"processed {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.1f} fps)")
    out = args.out or os.path.expanduser(
        f"~/slam_results/{time.strftime('%Y%m%d_%H%M%S')}")
    export_results(out, eng, sources=spec.video_paths)
    print(f"results exported to {out}")
    return eng


if __name__ == "__main__":
    main()
