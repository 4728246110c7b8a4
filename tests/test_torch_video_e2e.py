"""The port's real-video path end to end (the port copy of
tests/test_video_e2e.py): reference-format input.txt + calibration files
+ AVI videos -> parse -> decode through cv2 -> native threaded loader ->
engine on the CPU -> reference-format export, driven through
``python -m coslam_torch.cli``."""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.slow

cv2 = pytest.importorskip("cv2")

H, W, F, C = 120, 160, 24, 1
K1 = np.array([[140.0, 0, 80], [0, 140.0, 60], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def video_inputs(tmp_path_factory):
    """Per-camera AVI files, calibration files and input.txt."""
    from coslam_torch.io.calib import write_calib_file
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_batch)
    root = tmp_path_factory.mktemp("video_e2e")
    planes = make_room(np.random.default_rng(3), size=10.0)
    Rr, tr = orbit_trajectory(F, forward=0.05)
    imgs = render_batch(planes, K1, Rr, tr, H, W, device="cpu").numpy()
    for c in range(C):
        vw = cv2.VideoWriter(str(root / f"cam{c}.avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (W, H))
        assert vw.isOpened()
        for f in range(F):
            g = np.clip(imgs[f], 0, 255).astype(np.uint8)
            vw.write(cv2.cvtColor(g, cv2.COLOR_GRAY2BGR))
        vw.release()
        write_calib_file(str(root / f"cam{c}_calib.txt"), K1,
                         np.zeros(5, np.float32))
    with open(root / "input.txt", "w") as fh:
        fh.write(f"{C}\n")
        for c in range(C):
            fh.write("0 10\n")                      # skip / init frames
        for c in range(C):
            fh.write(f"{root / f'cam{c}.avi'}\n")
        for c in range(C):
            fh.write(f"{root / f'cam{c}_calib.txt'}\n")
    return root


def test_video_to_export_roundtrip(video_inputs, tmp_path):
    from coslam_torch import cli
    from coslam_torch.io.export import load_campose
    out_dir = str(tmp_path / "results")
    cli.main([str(video_inputs / "input.txt"), "--out", out_dir, "--cpu",
              "--small"])
    cam0 = os.path.join(out_dir, "0_campose.txt")
    assert os.path.exists(cam0)
    Rs, ts = load_campose(cam0)
    assert Rs.shape == (F, 3, 3) and ts.shape == (F, 3)
    assert np.isfinite(Rs).all() and np.isfinite(ts).all()
    RtR = np.einsum("fij,fik->fjk", Rs, Rs)
    assert np.abs(RtR - np.eye(3)).max() < 1e-2
    centers = -np.einsum("fji,fj->fi", Rs, ts)
    assert np.linalg.norm(centers[-1] - centers[0]) > 0.01
    assert os.path.exists(os.path.join(out_dir, "mappts.txt"))
    assert os.path.exists(os.path.join(out_dir, "input_videos.txt"))
    # the decode cache (AVI -> raw) was created by the video path
    assert os.path.exists(str(video_inputs / "cam0.avi.csrw"))
