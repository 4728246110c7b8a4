"""Result export in the reference's on-disk format (the port of
``coslam_tpu/io/export.py``; the files are byte-compatible with that
package's: same names, line order and number formats).

Mirrors CoSLAM::exportResults (SL_CoSLAM.cpp:1914-2031; format documented
README.md:126-176): a directory containing

  input_videos.txt     one line per camera (source identifier)
  mappts.txt           id x y z cov[0..8]       (one point per line)
  <c>_campose.txt      f R[0..8] t[0..2]        (one frame per line)
  <c>_featpts.txt      f id x y                 (mapped features per frame)

so downstream tooling written for the reference keeps working. Every
value is formatted from numpy arrays pulled from the engine.
"""

from __future__ import annotations

import os

import numpy as np

from coslam_torch.util import to_host


def export_results(out_dir: str, engine, sources: list[str] | None = None):
    """engine: CoSlamEngine after a run."""
    os.makedirs(out_dir, exist_ok=True)
    C = engine.cfg.num_cameras
    sources = sources or [f"camera_{c}" for c in range(C)]
    with open(os.path.join(out_dir, "input_videos.txt"), "w") as f:
        for s in sources:
            f.write(s + "\n")
    ids, xyz, cov = engine.map_points()
    with open(os.path.join(out_dir, "mappts.txt"), "w") as f:
        for i, x, cv in zip(ids, xyz, cov):
            vals = " ".join(f"{v:.6f}" for v in
                            np.concatenate([x, cv.reshape(-1)]))
            f.write(f"{int(i)} {vals}\n")
    for c in range(C):
        Rs, ts = engine.trajectory(c, correct=True)
        with open(os.path.join(out_dir, f"{c}_campose.txt"), "w") as f:
            for fr in range(Rs.shape[0]):
                vals = " ".join(f"{v:.8f}" for v in
                                np.concatenate([Rs[fr].reshape(-1), ts[fr]]))
                f.write(f"{fr} {vals}\n")
    # mapped features: the full per-frame history when the engine logged
    # it (log_features=True; the trajectory above drained the buffers that
    # fill it), else the final frame's snapshot
    if engine.feat_log:
        files = [open(os.path.join(out_dir, f"{c}_featpts.txt"), "w")
                 for c in range(C)]
        for (fr, c, fids, xy) in engine.feat_log:
            for k in range(len(fids)):
                files[c].write(f"{fr} {fids[k]} {xy[k, 0]:.3f} "
                               f"{xy[k, 1]:.3f}\n")
        for f in files:
            f.close()
    else:
        tracks = engine.state.tracks
        pos, mpt, valid, fr = to_host(tracks.pos, tracks.mpt, tracks.valid,
                                      engine.state.frame)
        fr = int(fr)
        for c in range(C):
            with open(os.path.join(out_dir, f"{c}_featpts.txt"), "w") as f:
                for n in range(pos.shape[1]):
                    if valid[c, n] and mpt[c, n] >= 0:
                        f.write(f"{fr} {mpt[c, n]} {pos[c, n, 0]:.3f} "
                                f"{pos[c, n, 1]:.3f}\n")


def load_campose(path: str):
    """Read a <c>_campose.txt back into ([F,3,3], [F,3])."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    Rs = data[:, 1:10].reshape(-1, 3, 3)
    ts = data[:, 10:13]
    return Rs.astype(np.float32), ts.astype(np.float32)
