"""Offline visualization of an exported results directory (the port of
``examples/visualize_results.py``).

Headless stand-in for the reference's GL panes: writes a PLY point cloud
(map points and densified trajectory polylines) viewable in MeshLab or
CloudCompare, and, where matplotlib imports, a top-down PNG and the 3D
scene pane (``coslam_torch.io.viz``). It reads and writes files only and
runs no device code.

    python -m coslam_torch.examples.visualize_results <results_dir>
        [--out scene.ply]
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np


def load_results(d):
    """(map points [N, 3] float32, camera-centre trajectories) of an
    export directory."""
    from coslam_torch.io.export import load_campose
    pts = []
    mappts_path = os.path.join(d, "mappts.txt")
    if os.path.exists(mappts_path):
        with open(mappts_path) as f:
            for ln in f:
                v = ln.split()
                if len(v) >= 4:
                    pts.append([float(v[1]), float(v[2]), float(v[3])])
    trajs = []
    c = 0
    while os.path.exists(os.path.join(d, f"{c}_campose.txt")):
        Rs, ts = load_campose(os.path.join(d, f"{c}_campose.txt"))
        trajs.append(-np.einsum("fji,fj->fi", Rs, ts))
        c += 1
    return np.array(pts, np.float32), trajs


_CAM_COLORS = [(255, 64, 64), (64, 160, 255), (64, 220, 96),
               (255, 200, 32), (220, 64, 255), (32, 220, 220)]
DENSIFY = 8                 # points a trajectory segment in the PLY


def write_ply(path, pts, trajs):
    """ASCII PLY: the map points in grey, then each trajectory's polyline
    in its camera's colour, ``DENSIFY`` points a segment."""
    rows = []
    for p in pts:
        rows.append((p[0], p[1], p[2], 200, 200, 200))
    for c, tr in enumerate(trajs):
        col = _CAM_COLORS[c % len(_CAM_COLORS)]
        # densify the polyline so it reads as a path in point-cloud viewers
        for k in range(len(tr) - 1):
            for a in np.linspace(0, 1, DENSIFY, endpoint=False):
                q = tr[k] * (1 - a) + tr[k + 1] * a
                rows.append((q[0], q[1], q[2], *col))
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(rows)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for r in rows:
            f.write(f"{r[0]:.4f} {r[1]:.4f} {r[2]:.4f} {r[3]} {r[4]} {r[5]}\n")


def write_png(path, pts, trajs):
    """The top-down plot; False (and nothing written) without
    matplotlib."""
    if importlib.util.find_spec("matplotlib") is None:
        return False
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 8))
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=2, c="#999999", label="map")
    for c, tr in enumerate(trajs):
        col = np.array(_CAM_COLORS[c % len(_CAM_COLORS)]) / 255.0
        ax.plot(tr[:, 0], tr[:, 2], color=col, lw=2, label=f"cam {c}")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title("map points + camera trajectories (top-down)")
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return True


def main(argv=None):
    """Returns the paths written."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("results_dir")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    pts, trajs = load_results(args.results_dir)
    out = args.out or os.path.join(args.results_dir, "scene.ply")
    write_ply(out, pts, trajs)
    print(f"wrote {out} ({len(pts)} map points, {len(trajs)} trajectories)")
    written = [out]
    png = os.path.splitext(out)[0] + ".png"
    if write_png(png, pts, trajs):
        print(f"wrote {png}")
        # the full 3D scene pane (the GLScenePane's role)
        from coslam_torch.io.viz import render_export_dir
        scene3d = os.path.splitext(out)[0] + "_3d.png"
        render_export_dir(args.results_dir, scene3d)
        print(f"wrote {scene3d}")
        written += [png, scene3d]
    return written


if __name__ == "__main__":
    main()
