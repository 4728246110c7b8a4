"""The port's monocular engine on its own (``coslam_torch`` only, CPU): the
checks of tests/test_pipeline_mono.py on a 60-frame run that reaches the
periodic duplicate unification at frame 50, on frames the port renders
itself, and a distorted-lens run on frames the JAX package warps."""

import numpy as np
import pytest

import torch_parity as tp

F = 60


@pytest.fixture(scope="module")
def mono_run():
    from coslam_torch.config import small_test_config
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence)
    from coslam_torch.slam.pipeline import CoSlamEngine
    planes = make_room(np.random.default_rng(0), size=10.0)
    Rs, ts = orbit_trajectory(F, forward=0.06)
    frames = render_sequence(planes, tp.KMAT[0], Rs, ts, tp.H, tp.W,
                             device="cpu")
    eng = CoSlamEngine(small_test_config(1, tp.H, tp.W), tp.KMAT, tp.KC,
                       device="cpu")
    calls = []
    from coslam_torch.slam import pipeline
    real = pipeline.fuse_close_points

    def spy(state, cfg):
        calls.append(eng.frame)
        return real(state, cfg)
    pipeline.fuse_close_points = spy
    try:
        for f in range(F):
            eng.process_frame(frames[f][None])
    finally:
        pipeline.fuse_close_points = real
    return eng, Rs, ts, calls


def test_bootstrap_keyframes_and_ba(mono_run):
    eng, _, _, _ = mono_run
    assert eng.bootstrapped
    assert len(eng.kf_frames) >= 3
    assert eng.ba_runs >= len(eng.kf_frames) - 2


def test_tracks_and_map_alive(mono_run):
    eng, _, _, _ = mono_run
    assert eng.stats_log[-1]["n_inliers"][0] > 40
    ids, xyz, cov = eng.map_points()
    assert len(ids) > 60
    assert np.isfinite(xyz).all() and np.isfinite(cov).all()
    assert (np.abs(xyz[:, :2]) < 15).mean() > 0.95


def test_ate_within_bound(mono_run):
    from coslam_torch.io.ate import ate_rmse
    eng, Rs_gt, ts_gt, _ = mono_run
    Rs, ts = eng.trajectory(0, correct=True)
    assert Rs.shape == (F, 3, 3)
    assert ate_rmse(Rs, ts, Rs_gt, ts_gt) < 0.20
    Rr, tr = eng.trajectory(0, correct=False)
    assert ate_rmse(Rr, tr, Rs_gt, ts_gt) < 0.25


def test_reprojection_and_fusion_cadence(mono_run):
    eng, _, _, calls = mono_run
    errs = [s["med_err"][0] for s in eng.stats_log if "med_err" in s]
    assert np.nanmedian(errs) < 0.5
    assert calls == [50]


def test_distorted_lens():
    """kc != 0: the tracker works on raw pixels, the SLAM core on
    undistorted ones."""
    from coslam_tpu.io.synthetic import (apply_distortion_warp, make_room,
                                         orbit_trajectory, render)
    from coslam_torch.config import small_test_config
    from coslam_torch.io.ate import ate_rmse
    from coslam_torch.slam.pipeline import CoSlamEngine
    kc = np.array([-0.25, 0.08, 1e-3, -5e-4, 0.0], np.float32)
    planes = make_room(np.random.default_rng(0), size=10.0)
    n = 40
    Rs, ts = orbit_trajectory(n, forward=0.06)
    frames = np.stack([np.asarray(apply_distortion_warp(
        render(planes, tp.KMAT[0], Rs[f], ts[f], tp.H, tp.W), tp.KMAT[0],
        kc)) for f in range(n)])
    eng = CoSlamEngine(small_test_config(1, tp.H, tp.W), tp.KMAT, kc[None],
                       device="cpu")
    for f in range(n):
        eng.process_frame(frames[f][None])
    assert eng.bootstrapped
    assert ate_rmse(*eng.trajectory(0, True), Rs, ts) < 0.25
