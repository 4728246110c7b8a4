"""Camera blackout and recovery at test scale (ROADMAP A21): the scene of
tests/test_occlusion.py (two cameras on a rig, 150x200, 110 frames,
camera 1's lens covered by noise over frames 25-43), rendered by the JAX
package, through ``coslam_torch``'s engine and ``coslam_tpu``'s, the port
drawing the JAX package's RANSAC samples (``torch_parity.
jax_ransac_draws``), so that the two differ in float32 sums only.

The port is held against the JAX engine's own run on the same frames,
not against that file's assertions (its third test fails on the
reference: the rig re-splits after the realignment, VERDICT.md). What
follows the blackout sits on a knife edge in the reference itself: on
these frames the JAX engine commits a realignment at frame 81 from a
12-inlier bridge (the PnP floor is 10) whose baseline is 0.08 units
against the rig's 1.0, and the rig splits again at 101; on the same
frames perturbed by +-0.01 grey (seeds 1, 2, 3) it commits none, none,
and one at frame 101. The port, on the unperturbed frames, commits none
(its bridge at frame 81: 3 inliers); perturbed, none, none, and one at
101, as the reference. So the comparison holds what the reference holds:
- the blackout split: the same grouping, within 2 frames of the JAX
  run's, inside frames 25-53;
- every merge either run commits is a realignment (neither ``noop`` nor
  ``reunify``) after uncover (frame >= 43) on at least 10 bridge matches;
  both merge logs are printed;
- camera 0 (never covered) within 0.05 + 25% of the JAX run's ATE, and
  camera 1 (whose ATE over the run moves with the merge: 1.02-1.83 in
  the reference's four runs) no worse than the JAX run's by more than
  that band."""

import numpy as np
import pytest

import torch_parity as tp

C, F = 2, 110
F0, F1 = 25, 43                      # camera 1 covered


def scene():
    """The JAX-rendered frames [F, C, H, W] and ground truth."""
    from coslam_tpu.io.synthetic import (make_room, multi_cam_rig,
                                         orbit_trajectory, render_sequence)
    rng = np.random.default_rng(0)
    planes = make_room(rng, size=10.0)
    Rr, tr = orbit_trajectory(F, forward=0.06)
    rot_c, offs_c = multi_cam_rig(C, baseline=1.0)
    Rs_gt = np.zeros((C, F, 3, 3), np.float32)
    ts_gt = np.zeros((C, F, 3), np.float32)
    frames = np.zeros((F, C, tp.H, tp.W), np.float32)
    for f in range(F):
        c_rig = -Rr[f].T @ tr[f]
        for c in range(C):
            Rs_gt[c, f] = rot_c[c] @ Rr[f]
            ts_gt[c, f] = -Rs_gt[c, f] @ (c_rig + Rr[f].T @ offs_c[c])
    for c in range(C):
        frames[:, c] = render_sequence(planes, tp.KMAT[0], Rs_gt[c],
                                       ts_gt[c], tp.H, tp.W)
    frames[F0:F1, 1] = rng.uniform(0, 30, frames[F0:F1, 1].shape).astype(
        np.float32)
    return frames, Rs_gt, ts_gt


@pytest.fixture(scope="module")
def runs():
    frames, Rs_gt, ts_gt = scene()
    return tp.run_scenario(frames), Rs_gt, ts_gt


def test_blackout_split_agrees(runs):
    out = runs[0]
    first = {k: tp.transitions(out[k]["groups"])[:1] for k in out}
    assert first["jax"] and first["port"], first
    (fj, pj), (fp, pp) = first["jax"][0], first["port"][0]
    assert pp == pj == (0, 1), first
    assert abs(fp - fj) <= 2 and F0 <= fp <= F1 + 10, first


def test_merges_are_realignments_after_uncover(runs):
    out = runs[0]
    for k in ("jax", "port"):
        for m in out[k]["merge_log"]:
            assert not m.get("noop") and not m.get("reunify"), (k, m)
            assert m["frame"] >= F1 and m["n_matches"] >= 10, (k, m)


def test_ate_per_camera_within_band(runs):
    from coslam_torch.io.ate import ate_rmse
    out, Rs_gt, ts_gt = runs
    a = [{k: ate_rmse(*out[k]["trajs"][c], Rs_gt[c], ts_gt[c])
          for k in ("jax", "port")} for c in range(C)]
    for c in range(C):
        print(f"camera {c}: ATE jax {a[c]['jax']:.4f} port "
              f"{a[c]['port']:.4f}")
        assert np.isfinite(a[c]["port"])
    band = [0.05 + 0.25 * a[c]["jax"] for c in range(C)]
    assert abs(a[0]["port"] - a[0]["jax"]) <= band[0], a
    assert a[1]["port"] - a[1]["jax"] <= band[1], a
