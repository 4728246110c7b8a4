"""The port's multi-camera engine end to end (BASELINE configs 2 and 3):
``coslam_torch``'s CoSlamEngine against ``coslam_tpu``'s on the 20-frame
two-camera rig of tests/test_pipeline_multicam.py (150x200, baseline 1.0,
forward 0.06), both fed the same JAX-rendered frames; and a slow-tier copy
of that file's three-camera dynamic-scene test on the port alone.

Bands, and why: the RANSAC streams of the map init differ (``jax.random``
against a seeded ``torch.Generator``) and float32 sums run in another
order, so the runs are compared by outcome: both bootstrap at frame 0,
the same group ids, keyframe lists equal or one entry apart, per-camera
centres within 5% of the path after Sim(3) alignment, and every camera's
ATE under 0.25 (the bound of test_two_cam_ate)."""

import numpy as np
import pytest

import torch_parity as tp

C = 2
F = 20


@pytest.fixture(scope="module")
def runs():
    from coslam_torch.config import small_test_config
    from coslam_torch.slam.pipeline import CoSlamEngine
    frames, Rs, ts = tp.render_rig_frames(C, F)
    ref = tp.run_jax_engine(frames)
    eng = CoSlamEngine(small_test_config(C, tp.H, tp.W), *tp.kmats(C),
                       device="cpu")
    for f in range(F):
        eng.process_frame(frames[f])
    return ref, eng, Rs, ts


def test_bootstrap_at_frame_zero(runs):
    ref, eng, _, _ = runs
    assert eng.bootstrapped
    assert tp.boot_frame(eng.stats_log) == ref["boot_frame"] == 0
    assert eng.kf_frames[0] == 0
    assert len(eng.stats_log) == F


def test_groups_keyframes_and_ba(runs):
    ref, eng, _, _ = runs
    np.testing.assert_array_equal(eng.group_id, ref["group_id"])
    assert eng.group_hist == ref["group_hist"] == [(0, 0)] * F
    a, b = eng.kf_frames, ref["kf_frames"]
    assert abs(len(a) - len(b)) <= 1 and len(set(a) ^ set(b)) <= 2, (a, b)
    assert eng.ba_runs >= len(a) - 2


def test_ate_per_camera(runs):
    from coslam_torch.io.ate import ate_rmse
    ref, eng, Rs_gt, ts_gt = runs
    for c in range(C):
        Rs, ts = eng.trajectory(c, correct=True)
        assert Rs.shape == (F, 3, 3) and ts.shape == (F, 3)
        assert np.isfinite(Rs).all() and np.isfinite(ts).all()
        assert ate_rmse(Rs, ts, Rs_gt[c], ts_gt[c]) < 0.25, c
        assert ate_rmse(*ref["trajs"][c], Rs_gt[c], ts_gt[c]) < 0.25, c


def test_trajectories_agree(runs):
    from coslam_torch.io.ate import camera_centers, umeyama
    ref, eng, _, _ = runs
    for c in range(C):
        c_port = camera_centers(*eng.trajectory(c, correct=True))
        c_ref = camera_centers(*ref["trajs"][c])
        s, R, t = umeyama(c_port, c_ref)
        gap = np.linalg.norm((s * (R @ c_port.T)).T + t - c_ref, axis=-1)
        path = np.linalg.norm(np.diff(c_ref, axis=0), axis=-1).sum()
        assert np.sqrt(np.mean(gap ** 2)) < 0.05 * path, (c, gap)


def test_collaboration_stats(runs):
    """Inter-camera mapping contributes in both, classification counts the
    static map, the joint pose is not needed on a static scene, and the
    map is finite and in the room."""
    ref, eng, _, _ = runs
    inter = [s.get("n_intercam_points", 0) for s in eng.stats_log]
    ref_inter = [s.get("n_intercam_points", 0) for s in ref["stats_log"]]
    assert sum(inter) > 0 and sum(ref_inter) > 0
    assert abs(sum(inter) - sum(ref_inter)) <= 0.2 * sum(ref_inter)
    last = eng.stats_log[-1]
    assert last["n_static"] > 100 and last["n_dynamic"] == 0
    assert not any(s.get("joint_pose") for s in eng.stats_log)
    ids, xyz, cov = eng.map_points()
    assert len(ids) > 100
    assert np.isfinite(xyz).all() and np.isfinite(cov).all()
    assert (np.abs(xyz[:, :2]) < 15).mean() > 0.95


# ------------------------------------------------- slow: three cameras --

@pytest.fixture(scope="module")
def three_cam_dynamic():
    """tests/test_pipeline_multicam.py's three-camera dynamic scene (the
    JAX package renders it), on the port's engine."""
    from coslam_tpu.io.synthetic import MovingQuad, make_texture
    from coslam_torch.config import small_test_config
    from coslam_torch.slam.pipeline import CoSlamEngine
    rng = np.random.default_rng(0)
    quad = MovingQuad(center0=np.array([-3.0, 0.5, 13.0], dtype=np.float32),
                      velocity=np.array([0.12, 0.0, 0.0], dtype=np.float32),
                      eu=np.array([2.2, 0.0, 0.0], dtype=np.float32),
                      ev=np.array([0.0, 2.2, 0.0], dtype=np.float32),
                      tex=make_texture(rng))
    frames, Rs_gt, ts_gt = tp.render_rig_frames(3, 50, baseline=0.9,
                                                forward=0.05, quads=[quad],
                                                rng=rng)
    eng = CoSlamEngine(small_test_config(3, tp.H, tp.W), *tp.kmats(3),
                       device="cpu")
    for f in range(frames.shape[0]):
        eng.process_frame(frames[f])
    return eng, Rs_gt, ts_gt, quad


@pytest.mark.slow
def test_three_cam_dynamic(three_cam_dynamic):
    """The checks of test_three_cam_ate, _dynamic_points_follow_object,
    _statics_dominate and _intercam_mapping_contributes."""
    from coslam_torch.io.ate import ate_rmse
    from coslam_torch.slam.state import PT_DYNAMIC, ST_ALIVE
    eng, Rs_gt, ts_gt, quad = three_cam_dynamic
    for c in range(3):
        ate = ate_rmse(*eng.trajectory(c, True), Rs_gt[c], ts_gt[c])
        assert ate < 0.35, f"cam{c} ATE {ate}"
    last = [s for s in eng.stats_log if "n_static" in s][-1]
    assert last["n_static"] > 100
    assert last["n_dynamic"] >= 1
    assert last["n_static"] > 5 * last["n_dynamic"]
    assert sum(s.get("n_intercam_points", 0) for s in eng.stats_log) > 0
    # the quad's points are dynamic and their positions follow it
    assert len(eng.dyn_log) > 10
    st = eng.state
    tr, mp = st.tracks, st.mappts
    status, ptype = tp.n(mp.status), tp.n(mp.ptype)
    f_last = int(st.frame)
    qc = np.asarray(quad.center0) + f_last * np.asarray(quad.velocity)
    K1 = tp.KMAT[0]
    hits = {}
    for c in range(3):
        Xc = Rs_gt[c, f_last] @ qc + ts_gt[c, f_last]
        u = Xc[0] / Xc[2] * K1[0, 0] + K1[0, 2]
        v = Xc[1] / Xc[2] * K1[1, 1] + K1[1, 2]
        half = 1.1 / Xc[2] * K1[0, 0]
        pos, mpt = tp.n(tr.pos[c]), tp.n(tr.mpt[c])
        sel = tp.n(tr.valid[c]) & (mpt >= 0) \
            & (np.abs(pos[:, 0] - u) < half) & (np.abs(pos[:, 1] - v) < half)
        for s in mpt[sel]:
            hits[int(s)] = hits.get(int(s), 0) + 1
    quad_slots = [s for s, k in hits.items() if k >= 2
                  and status[s] == ST_ALIVE]
    dyn_slots = [s for s in quad_slots if ptype[s] == PT_DYNAMIC]
    assert len(dyn_slots) >= 2, (quad_slots, dyn_slots)
    by_id = {}
    for (f, ids, xyz) in eng.dyn_log:
        for i, p_ in zip(ids, xyz):
            by_id.setdefault(int(i), []).append((f, p_))
    good_vel = 0
    for s in dyn_slots:
        traj = by_id.get(s, [])
        if len(traj) < 8:
            continue
        fs = np.array([a for a, _ in traj], float)
        ps = np.stack([b for _, b in traj])
        A = np.stack([fs, np.ones_like(fs)], -1)
        vel = np.linalg.lstsq(A, ps, rcond=None)[0][0]
        if vel[0] > 0 and abs(vel[1]) < max(vel[0], 1e-6):
            good_vel += 1
    assert good_vel >= 1, {s: len(by_id.get(s, [])) for s in dyn_slots}


# ------------------------------------- slow: the distorted rig (C3) --

@pytest.mark.slow
def test_distorted_rig_from_the_reference_bootstrap(monkeypatch):
    """The reference's distorted rig (three cameras, k1 = -0.25, k2 =
    0.08) at 240x320, f = 250, 100 frames: the port's engine takes over
    the JAX engine's bootstrap (``tp._hand_over``, after its own at the
    same frame, which the JAX package's RANSAC samples give it) and then
    tracks as the reference does: keyframes as ``tp.check_keyframes``
    holds them, centres within 5% of the path, each camera's ATE within 0.1% of the
    path of the reference's (measured: 1.9921/1.4049/1.5312% against
    2.0008/1.4057/1.5359%). So where the two engines part on this rig,
    each from its own map init, the gap is the init's (ROADMAP C3)."""
    import jax
    import jax.numpy as jnp
    import torch
    from coslam_tpu.config import CapacityConfig as JCap
    from coslam_tpu.config import KLTConfig as JKLT
    from coslam_tpu.config import SlamConfig as JCfg
    from coslam_tpu.slam.pipeline import CoSlamEngine as JEngine
    from coslam_torch.config import CapacityConfig, KLTConfig, SlamConfig
    from coslam_torch.geometry import epipolar as tepi
    from coslam_torch.io.ate import ate_rmse, camera_centers
    from coslam_torch.io.synthetic import (apply_distortion_warp, make_room,
                                           render_batch, rig_sequence)
    from coslam_torch.slam.pipeline import CoSlamEngine as TEngine

    def jax_samples(gen, mask, n_hyp, size):
        logits = jnp.where(jnp.asarray(tp.n(mask)), 0.0, -1e9)
        key = jax.random.PRNGKey(gen.initial_seed())
        return torch.from_numpy(np.asarray(jax.random.categorical(
            key, logits[None, :], shape=(n_hyp, size))).astype(np.int64))

    def jax_seed(gen):
        return int(jax.random.randint(jax.random.PRNGKey(gen.initial_seed()),
                                      (), 0, 2 ** 31 - 1))
    monkeypatch.setattr(tepi, "sample_indices", jax_samples)
    monkeypatch.setattr(tepi, "sample_seed", jax_seed)
    h, w, nc, n = 240, 320, 3, 100
    K = np.array([[250.0, 0, w / 2], [0, 250.0, h / 2], [0, 0, 1]],
                 np.float32)
    KK = np.repeat(K[None], nc, 0)
    kc = np.zeros((nc, 5), np.float32)
    kc[:, 0], kc[:, 1] = -0.25, 0.08
    rng = np.random.default_rng(0)
    rng.uniform()
    planes = make_room(rng, size=10.0)
    Rs, ts = rig_sequence(nc, n, baseline=1.0, forward=0.04)
    views = render_batch(planes, K, Rs.transpose(1, 0, 2, 3).reshape(-1, 3, 3),
                         ts.transpose(1, 0, 2).reshape(-1, 3), h, w,
                         frames=np.repeat(np.arange(n), nc),
                         device="cpu").reshape(n, nc, h, w)
    frames = tp.n(torch.stack(
        [apply_distortion_warp(views[:, c], K, kc[c]) for c in range(nc)],
        1).clamp(0, 255).round())
    kw = dict(num_cameras=nc, image_height=h, image_width=w)
    cap = dict(max_features=256, max_map_points=2048, max_keyframes=64,
               ba_window=5)
    ref = tp._drive(JEngine(JCfg(klt=JKLT(n_levels=3), cap=JCap(**cap),
                                 **kw), KK, kc), frames, (), tp.to_numpy)
    port = tp._drive(TEngine(SlamConfig(klt=KLTConfig(n_levels=3),
                                        cap=CapacityConfig(**cap), **kw),
                             KK, kc, device="cpu"),
                     frames, (), None, ref["boot"])
    assert port["boot_frame"] == ref["boot_frame"]
    tp.check_keyframes(ref, port)
    path = float(np.linalg.norm(np.diff(camera_centers(Rs[0], ts[0]),
                                        axis=0), axis=-1).sum())
    for c in range(nc):
        gap, length = tp.aligned_gap(port["trajs"][c], ref["trajs"][c])
        assert gap < 0.05 * length, c
        a_ref = ate_rmse(*ref["trajs"][c], Rs[c], ts[c]) / path
        a_port = ate_rmse(*port["trajs"][c], Rs[c], ts[c]) / path
        print(f"camera {c}: ATE {100 * a_port:.4f}% of the path "
              f"(JAX {100 * a_ref:.4f}%)")
        assert abs(a_port - a_ref) < 1e-3, c
