"""A mover crossing a fixed rig at test scale (ROADMAP A21): the scene of
tests/test_mover_crossing.py (three cameras, 150x200, 90 frames, seed 2;
a large textured quad sweeps across the shared view at close range),
rendered by the JAX package, through ``coslam_torch``'s engine and
``coslam_tpu``'s, the port drawing the JAX package's RANSAC samples
(``torch_parity.jax_ransac_draws``). With its own draws the port's
three-camera map init fails at frame 0 on this scene, in eight runs of
eight (frames perturbed by +-0.01 grey), and succeeds at frame 1, where
the JAX package's succeeds at frame 0 in all eight; handed the JAX
package's samples it succeeds at frame 0: the samples, not the init,
part them (as in ROADMAP C3's study).

The port is held against the JAX engine's own run on the same frames,
not against that file's assertions. That file calls the crossing
"chaotic run to run", so both runs are printed. Bands, and why: float32
sums run in another order, so the runs are compared by outcome (the
reference on frames perturbed by +-0.01 grey, seeds 1 and 2, and the
port on seeds 1-3, keep no transition and no merge; the reference's ATE
moves by up to 0.05 a camera): the same groupings, each reached within 2
frames; the same merges (count, ``noop`` and ``reunify`` flags), each
within 2 frames, with bridge matches within 20%; and each camera's ATE
(chain scales, as that file scores it) within 0.05 + 25% of the JAX
run's."""

import numpy as np
import pytest

import torch_parity as tp

C, F = 3, 90


def scene():
    """The JAX-rendered frames [F, C, H, W] and ground truth."""
    from coslam_tpu.io.synthetic import (MovingQuad, make_room, make_texture,
                                         multi_cam_rig, orbit_trajectory,
                                         render_sequence)
    rng = np.random.default_rng(2)
    planes = make_room(rng, size=10.0)
    Rr, tr = orbit_trajectory(F, forward=0.03)
    rot_c, offs_c = multi_cam_rig(C, baseline=0.9)
    Rs_gt = np.zeros((C, F, 3, 3), np.float32)
    ts_gt = np.zeros((C, F, 3), np.float32)
    frames = np.zeros((F, C, tp.H, tp.W), np.float32)
    quad = MovingQuad(center0=np.array([-4.5, 0.3, 6.0], np.float32),
                      velocity=np.array([0.16, 0.0, 0.0], np.float32),
                      eu=np.array([2.6, 0.0, 0.0], np.float32),
                      ev=np.array([0.0, 2.6, 0.0], np.float32),
                      tex=make_texture(rng))
    for f in range(F):
        c_rig = -Rr[f].T @ tr[f]
        for c in range(C):
            Rs_gt[c, f] = rot_c[c] @ Rr[f]
            ts_gt[c, f] = -Rs_gt[c, f] @ (c_rig + Rr[f].T @ offs_c[c])
    for c in range(C):
        frames[:, c] = render_sequence(planes, tp.KMAT[0], Rs_gt[c],
                                       ts_gt[c], tp.H, tp.W, quads=[quad])
    return frames, Rs_gt, ts_gt


@pytest.fixture(scope="module")
def runs():
    frames, Rs_gt, ts_gt = scene()
    return tp.run_scenario(frames), Rs_gt, ts_gt


def test_group_transitions_agree(runs):
    out = runs[0]
    tp.assert_transitions_agree(out["port"]["groups"], out["jax"]["groups"])


def test_merge_logs_agree(runs):
    out = runs[0]
    tp.assert_merges_agree(out["port"]["merge_log"], out["jax"]["merge_log"])


def test_ate_per_camera_within_band(runs):
    from coslam_torch.io.ate import ate_rmse
    out, Rs_gt, ts_gt = runs
    for c in range(C):
        a = {k: ate_rmse(*out[k]["trajs_chain"][c], Rs_gt[c], ts_gt[c])
             for k in ("jax", "port")}
        print(f"camera {c}: ATE jax {a['jax']:.4f} port {a['port']:.4f}")
        assert np.isfinite(a["port"])
        assert abs(a["port"] - a["jax"]) <= 0.05 + 0.25 * a["jax"], (c, a)
