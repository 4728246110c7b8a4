"""Offline visualization of SLAM state and exported results (the port of
``coslam_tpu/io/viz.py``).

Headless replacement for the reference's GL panes (src/gui/): the scene
view (GLScenePane.h:27-67 — map points colored by state, camera frusta
per group, dynamic trajectories) and the per-camera image pane
(GLImagePane.h:16-80 — feature overlay, convex hulls, reprojection
errors). The same content renders to PNG from either a live engine (its
tensors taken to numpy after one wait) or an exported results directory
(the reference's slam_results format), so it also works on output
produced by the original C++ system. matplotlib is imported only when a
figure is drawn; where it is not installed, drawing raises.
"""

from __future__ import annotations

import os

import numpy as np

from coslam_torch.geometry.hull import convex_hull
from coslam_torch.util import to_host

# color scheme (matches the reference's semantic grouping: static map
# points dark, dynamic red, uncertain orange, false gray)
_PT_COLORS = {0: "#1f3a5f", 1: "#d62728", 2: "#ff9a3c"}
_GROUP_CMAP = ["#2a7de1", "#2aa876", "#9467bd", "#e17c2a", "#17becf",
               "#bcbd22", "#e377c2", "#8c564b", "#7f7f7f", "#aec7e8",
               "#98df8a", "#c5b0d5", "#ffbb78"]


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("matplotlib is not installed: the figures of "
                           "coslam_torch.io.viz need it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _camera_center(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return -R.T @ t


def _frustum_segments(R, t, K, h, w, depth):
    """3D line segments of a camera frustum (apex + 4 image-corner rays)."""
    c = _camera_center(R, t)
    corners_px = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    Kinv = np.linalg.inv(K)
    rays = (Kinv @ np.concatenate(
        [corners_px, np.ones((4, 1))], 1).T).T           # cam coords, z=1
    world = np.stack([R.T @ (r * depth - t) for r in rays])  # R^T (Xc - t)
    segs = [(c, world[i]) for i in range(4)]
    segs += [(world[i], world[(i + 1) % 4]) for i in range(4)]
    return segs


def render_scene(out_png: str, map_xyz: np.ndarray, map_type: np.ndarray,
                 trajectories: list[np.ndarray],
                 group_id: np.ndarray | None = None,
                 cam_R: np.ndarray | None = None,
                 cam_t: np.ndarray | None = None,
                 K: np.ndarray | None = None,
                 img_hw: tuple[int, int] | None = None,
                 dyn_trajectories: list[np.ndarray] | None = None,
                 title: str = "coslam_torch scene"):
    """3D scene figure: map points by type, per-camera trajectories colored
    by group, frusta at the current poses, dynamic-point trajectories."""
    plt = _plt()
    fig = plt.figure(figsize=(9, 7), dpi=110)
    ax = fig.add_subplot(111, projection="3d")
    for pt, color in _PT_COLORS.items():
        sel = map_type == pt
        if sel.any():
            ax.scatter(map_xyz[sel, 0], map_xyz[sel, 1], map_xyz[sel, 2],
                       s=2 if pt == 0 else 8, c=color, alpha=0.6,
                       label={0: "static", 1: "dynamic", 2: "uncertain"}[pt])
    for c, tr in enumerate(trajectories):
        g = int(group_id[c]) if group_id is not None else 0
        col = _GROUP_CMAP[g % len(_GROUP_CMAP)]
        ax.plot(tr[:, 0], tr[:, 1], tr[:, 2], c=col, lw=1.5,
                label=f"cam {c} (group {g})")
    if cam_R is not None and K is not None and img_hw is not None:
        span = 1.0
        if len(trajectories) and len(trajectories[0]) > 1:
            allt = np.concatenate(trajectories, 0)
            span = max(np.ptp(allt, axis=0).max(), 1e-3)
        for c in range(len(cam_R)):
            g = int(group_id[c]) if group_id is not None else 0
            col = _GROUP_CMAP[g % len(_GROUP_CMAP)]
            for a, b in _frustum_segments(cam_R[c], cam_t[c], K[c],
                                          img_hw[0], img_hw[1],
                                          depth=0.15 * span):
                ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]],
                        c=col, lw=0.8)
    if dyn_trajectories:
        for tr in dyn_trajectories:
            ax.plot(tr[:, 0], tr[:, 1], tr[:, 2], c=_PT_COLORS[1],
                    lw=0.7, alpha=0.8)
    ax.set_title(title)
    ax.legend(loc="upper right", fontsize=7)
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)


def render_image_pane(out_png: str, image: np.ndarray,
                      feat_px: np.ndarray, feat_kind: np.ndarray,
                      reproj_px: np.ndarray | None = None,
                      draw_hull: bool = True, title: str = ""):
    """Per-camera pane: frame + feature overlay. feat_kind: 0 mapped
    static, 1 mapped dynamic, 2 unmapped. ``reproj_px`` (same length)
    draws observation->reprojection error segments like the reference's
    error display (GLImagePane.h:33)."""
    plt = _plt()
    h, w = image.shape[:2]
    fig, ax = plt.subplots(figsize=(w / 110, h / 110), dpi=110)
    ax.imshow(image, cmap="gray", vmin=0, vmax=255)
    kinds = [(0, "#2a7de1", "o", "static"), (1, "#d62728", "o", "dynamic"),
             (2, "#2aa876", "x", "unmapped")]
    for k, col, mk, lab in kinds:
        sel = feat_kind == k
        if sel.any():
            if mk == "o":
                ax.scatter(feat_px[sel, 0], feat_px[sel, 1], s=12,
                           marker=mk, facecolors="none", edgecolors=col,
                           linewidths=0.9, label=lab)
            else:
                ax.scatter(feat_px[sel, 0], feat_px[sel, 1], s=12,
                           marker=mk, color=col, linewidths=0.9, label=lab)
    if reproj_px is not None:
        for i in range(len(feat_px)):
            if np.all(np.isfinite(reproj_px[i])):
                ax.plot([feat_px[i, 0], reproj_px[i, 0]],
                        [feat_px[i, 1], reproj_px[i, 1]],
                        c="#ff9a3c", lw=0.6)
    if draw_hull and len(feat_px) >= 3:
        hull = convex_hull(feat_px)
        if len(hull) >= 3:
            closed = np.concatenate([hull, hull[:1]], 0)
            ax.plot(closed[:, 0], closed[:, 1], c="#9467bd", lw=0.8,
                    ls="--", alpha=0.8)
    ax.set_xlim(0, w)
    ax.set_ylim(h, 0)
    ax.set_title(title, fontsize=8)
    ax.legend(loc="lower right", fontsize=6)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)


def render_engine(engine, out_dir: str, images: np.ndarray | None = None):
    """Render the full pane set from a live CoSlamEngine: one scene view +
    one image pane per camera (when current frames are given)."""
    os.makedirs(out_dir, exist_ok=True)
    st = engine.state
    mp = st.mappts
    tr = st.tracks
    status, xyz_all, ptype_all, group_id, R, t, frame, pos, valid, mptid = \
        to_host(mp.status, mp.xyz, mp.ptype, st.group_id, st.R, st.t,
                st.frame, tr.pos, tr.valid, tr.mpt)
    alive = status == 1
    xyz = xyz_all[alive]
    ptype = ptype_all[alive]
    C = engine.cfg.num_cameras
    centers = []
    for c in range(C):
        Rs, ts = engine.trajectory(c, correct=False)
        centers.append(np.stack([_camera_center(Rs[i], ts[i])
                                 for i in range(len(Rs))]))
    dyn = None
    if engine.dyn_log:
        by_id: dict[int, list[np.ndarray]] = {}
        for (_, ids, pts) in engine.dyn_log[-200:]:
            for i, p in zip(ids, pts):
                by_id.setdefault(int(i), []).append(p)
        dyn = [np.stack(v) for v in by_id.values() if len(v) >= 3]
    Ks = engine.K.cpu().numpy()
    render_scene(os.path.join(out_dir, "scene.png"), xyz, ptype, centers,
                 group_id=group_id, cam_R=R, cam_t=t, K=Ks,
                 img_hw=engine.img_hw, dyn_trajectories=dyn,
                 title=f"frame {int(frame)}")
    if images is not None:
        images = images.cpu().numpy() if hasattr(images, "cpu") \
            else np.asarray(images)
        for c in range(C):
            sel = valid[c]
            px = pos[c][sel]
            mid = mptid[c][sel]
            kind = np.full(len(px), 2, np.int32)
            mapped = mid >= 0
            kind[mapped] = np.where(
                ptype_all[mid[mapped]] == 1, 1, 0)
            render_image_pane(
                os.path.join(out_dir, f"cam{c}.png"), images[c], px, kind,
                title=f"camera {c} / frame {int(frame)}")


def render_export_dir(export_dir: str, out_png: str):
    """Scene figure straight from a results directory in the reference's
    slam_results format (ours or the original C++ system's)."""
    xyz = []
    ptsfile = os.path.join(export_dir, "mappts.txt")
    if os.path.exists(ptsfile):
        with open(ptsfile) as f:
            for line in f:
                v = line.split()
                if len(v) >= 4:
                    xyz.append([float(v[1]), float(v[2]), float(v[3])])
    xyz = np.asarray(xyz) if xyz else np.zeros((0, 3))
    trajs = []
    c = 0
    while os.path.exists(os.path.join(export_dir, f"{c}_campose.txt")):
        centers = []
        with open(os.path.join(export_dir, f"{c}_campose.txt")) as f:
            for line in f:
                v = np.asarray([float(x) for x in line.split()[1:]])
                R = v[:9].reshape(3, 3)
                t = v[9:12]
                centers.append(_camera_center(R, t))
        trajs.append(np.stack(centers))
        c += 1
    render_scene(out_png, xyz, np.zeros(len(xyz), np.int32), trajs,
                 title=os.path.basename(os.path.normpath(export_dir)))
