"""Stage and end-to-end parity of the monocular engine: ``coslam_torch``
against ``coslam_tpu`` at small_test_config(1, 150, 200) on 30 frames of
the synthetic room rendered by the JAX package.

The JAX engine runs once (module fixture) and leaves numpy snapshots of
its state after frames 12 and 27. Every stage test starts both packages
from one snapshot, moved across with ``state_from_numpy``, and feeds
both the same pyramids, so only the stage itself is compared.

Tolerances, and why:
- tracks (KLT, redetect): positions to 1e-3 px, at most two features
  whose validity flips at a threshold;
- pose update: rotations and translations to 1e-4 (a float32 IRLS over a
  few hundred points, sums reordered), inlier counts within 2;
- new map points: the same allocations but for two, points to 1e-3 of
  the scene depth;
- BA: poses to 1e-3, points seen twice or more to 1e-2 of the scene
  scale (an LM solve in float32, sums reordered, and segment sums by
  ``index_add_`` rather than ``segment_sum``);
- end to end, the RANSAC streams differ (``jax.random`` against a torch
  generator seeded with the frame number), so the runs are compared by
  bands: the same bootstrap frame, keyframe lists equal or one entry
  apart, per-frame camera centres within 0.05 of the scene scale after
  Sim(3) alignment, and the port's ATE under 0.20 (the bound of
  tests/test_pipeline_mono.py)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_parity as tp

F = 30
SNAPS = (12, 27)


@pytest.fixture(scope="module")
def ref():
    frames, Rs, ts = tp.render_mono_frames(F)
    run = tp.run_jax_engine(frames, snapshots=SNAPS)
    run.update(frames=frames, Rs_gt=Rs, ts_gt=ts)
    return run


@pytest.fixture(scope="module")
def cfgs():
    from coslam_tpu.config import small_test_config as jc
    from coslam_torch.config import small_test_config as tc
    return jc(1, tp.H, tp.W), tc(1, tp.H, tp.W)


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def ttree(tree):
    from coslam_torch.slam.state import state_from_numpy
    return state_from_numpy(tree, "cpu")


def kmats():
    return (jnp.asarray(tp.KMAT), jnp.asarray(tp.KC), tp.t(tp.KMAT),
            tp.t(tp.KC))


def jpyr(img):
    from coslam_tpu.ops import build_pyramid
    return build_pyramid(jnp.asarray(img[None]), 3)


def assert_tracks_close(jt, tt, max_flips=2, pos_tol=1e-3):
    jv, tv = np.asarray(jt.valid), tp.n(tt.valid)
    assert (jv != tv).sum() <= max_flips
    both = jv & tv
    assert both.sum() > 50
    for f in ("pos", "raw"):
        np.testing.assert_allclose(tp.n(getattr(tt, f))[both],
                                   np.asarray(getattr(jt, f))[both],
                                   atol=pos_tol, err_msg=f)
    for f in ("age", "mpt", "dyn_votes"):
        np.testing.assert_array_equal(tp.n(getattr(tt, f))[both],
                                      np.asarray(getattr(jt, f))[both],
                                      err_msg=f)
    hv = np.asarray(jt.hist_valid)
    assert (hv != tp.n(tt.hist_valid)).sum() <= 2 * max_flips * hv.shape[1]
    hb = hv & tp.n(tt.hist_valid)
    np.testing.assert_allclose(tp.n(tt.hist)[hb], np.asarray(jt.hist)[hb],
                               atol=pos_tol)


# ------------------------------------------------------------ stages ----

@pytest.fixture(scope="module")
def tracked13(ref, cfgs):
    """Frame 13 from snapshot 12: JAX advance_tracks output (state) and
    the pyramids both packages share."""
    from coslam_tpu.slam import steps as js
    st, pyr_prev = ref["snaps"][12]
    jK, jkc, _, _ = kmats()
    pyr_cur = tp.to_numpy(jpyr(ref["frames"][13]))
    jst = jtree(st)
    tracks = js.advance_tracks(jtree(pyr_prev), jtree(pyr_cur), jst.tracks,
                               jK, jkc, jst.frame + 1, cfgs[0])
    out = jst._replace(tracks=tracks, frame=jst.frame + 1)
    return tp.to_numpy(out), pyr_prev, pyr_cur


def test_advance_tracks(ref, cfgs, tracked13):
    from coslam_torch.slam import steps as ts_
    st, pyr_prev = ref["snaps"][12]
    want, _, pyr_cur = tracked13
    _, _, tK, tkc = kmats()
    tst = ttree(st)
    got = ts_.advance_tracks(tp.pyramid_to_torch(pyr_prev),
                             tp.pyramid_to_torch(pyr_cur), tst.tracks, tK,
                             tkc, tst.frame + 1, cfgs[1])
    assert_tracks_close(want.tracks, got)
    # refilled slots got fresh corners in both
    assert (np.asarray(want.tracks.age) == 1).sum() > 0


@pytest.mark.parametrize("large_err", [False, True])
def test_pose_update(cfgs, tracked13, large_err):
    from coslam_tpu.slam import steps as js
    from coslam_torch.slam import steps as ts_
    st = tracked13[0]
    jK, jkc, tK, tkc = kmats()
    jo = js.pose_update(jtree(st), jK, jkc, (tp.H, tp.W), cfgs[0],
                        large_err=large_err)
    to = ts_.pose_update(ttree(st), tK, tkc, (tp.H, tp.W), cfgs[1],
                         large_err=large_err)
    np.testing.assert_allclose(tp.n(to.R), np.asarray(jo.R), atol=1e-4)
    np.testing.assert_allclose(tp.n(to.t), np.asarray(jo.t), atol=1e-4)
    assert abs(int(to.n_inliers[0]) - int(jo.n_inliers[0])) <= 2
    assert int(jo.n_inliers[0]) > 40
    for f in ("coverage", "med_depth", "med_err"):
        np.testing.assert_allclose(tp.n(getattr(to, f)),
                                   np.asarray(getattr(jo, f)), rtol=2e-2,
                                   err_msg=f)
    jm, tm = np.asarray(jo.tracks.mpt), tp.n(to.tracks.mpt)
    assert (jm != tm).sum() <= 2
    # refined points: the reference scatters every feature's value to slot
    # clamp(mpt, 0), so a slot hit by two features (slot 0 under all the
    # unmapped ones) keeps whichever write XLA applies last; the port
    # writes the inliers only (ROADMAP.md, queue C). The slots one feature
    # hits are compared in the image, under the JAX pose, to 0.05 px, and
    # in space to 2% of their depth: the refinement's Kalman gain turns
    # the poses' 1e-4 float32 gap into motion along weakly fixed rays
    mpt = st.tracks.mpt[0]
    P = st.mappts.xyz.shape[0]
    single = np.bincount(np.clip(mpt, 0, None), minlength=P) <= 1
    x0, jx, tx = st.mappts.xyz, np.asarray(jo.mappts.xyz), \
        tp.n(to.mappts.xyz)
    assert (np.abs(jx - x0).max(1)[single] > 0).sum() > 20
    R, t = np.asarray(jo.R)[0], np.asarray(jo.t)[0]
    K = tp.KMAT[0]

    def px(X):
        Xc = X @ R.T + t
        return (Xc[:, :2] / Xc[:, 2:3]) * K[[0, 1], [0, 1]] + K[:2, 2]
    depth = np.abs(jx @ R[2] + t[2])
    sel = single & (depth > 1e-2)
    assert np.abs(px(tx[sel]) - px(jx[sel])).max() < 0.05
    assert (np.linalg.norm(tx - jx, axis=1)[sel] <= 0.02 * depth[sel]).all()
    np.testing.assert_array_equal(tp.n(to.mappts.last_obs),
                                  np.asarray(jo.mappts.last_obs))
    np.testing.assert_array_equal(tp.n(to.mappts.owner),
                                  np.asarray(jo.mappts.owner))


def test_push_pose_history(cfgs, tracked13):
    from coslam_tpu.slam import steps as js
    from coslam_torch.slam import steps as ts_
    st = tracked13[0]
    want = js.push_pose_history(jtree(st))
    got = ts_.push_pose_history(ttree(st))
    for f in ("pose_hist_R", "pose_hist_t", "pose_hist_long_R",
              "pose_hist_long_t"):
        np.testing.assert_array_equal(tp.n(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)


def test_new_map_points(ref, cfgs):
    """From snapshot 27, with the mature mapped tracks unbound from the map
    so that new_map_points has candidates to triangulate (the run itself
    creates one or two points a frame)."""
    from coslam_tpu.slam import steps as js
    from coslam_torch.slam import steps as ts_
    st, pyr = ref["snaps"][27]
    mpt = st.tracks.mpt.copy()
    cand = (mpt[0] >= 0) & (st.tracks.age[0] >= 6)
    assert cand.sum() > 40
    mpt[0, cand] = -1
    st = st._replace(tracks=st.tracks._replace(mpt=mpt))
    jK, jkc, tK, tkc = kmats()
    jm, jtr, jn = js.new_map_points(jtree(st), jtree(pyr), jK, jkc, cfgs[0])
    tm, ttr, tn = ts_.new_map_points(ttree(st), tp.pyramid_to_torch(pyr),
                                     tK, tkc, cfgs[1])
    assert int(jn) > 5
    assert abs(int(tn) - int(jn)) <= 2
    jmpt, tmpt = np.asarray(jtr.mpt), tp.n(ttr.mpt)
    assert (jmpt != tmpt).sum() <= 2
    ja, ta = np.asarray(jm.status), tp.n(tm.status)
    assert (ja != ta).sum() <= 2
    same = (ja == ta) & (ja == 1)
    depth = np.median(np.abs(np.asarray(jm.xyz)[same, 2]))
    np.testing.assert_allclose(tp.n(tm.xyz)[same], np.asarray(jm.xyz)[same],
                               atol=1e-3 * depth)
    np.testing.assert_allclose(tp.n(tm.cov)[same], np.asarray(jm.cov)[same],
                               rtol=1e-2, atol=1e-6)
    for f in ("gen", "first_frame", "last_obs", "owner", "ptype"):
        np.testing.assert_array_equal(tp.n(getattr(tm, f))[same],
                                      np.asarray(getattr(jm, f))[same],
                                      err_msg=f)
    np.testing.assert_array_equal(tp.n(tm.ncc_valid)[same],
                                  np.asarray(jm.ncc_valid)[same])
    np.testing.assert_allclose(tp.n(tm.ncc)[same], np.asarray(jm.ncc)[same],
                               atol=1e-4)


def test_lifecycle_and_rank(ref, cfgs):
    from coslam_tpu.slam import steps as js
    from coslam_torch.slam import steps as ts_
    st = ref["snaps"][27][0]
    mp = st.mappts
    status = mp.status.copy()
    status[::7] = 2                                      # some false points
    mp = mp._replace(status=status)
    want = js.lifecycle_update(jtree(mp), jnp.asarray(27), cfgs[0])
    got = ts_.lifecycle_update(ttree(mp), torch.tensor(27), cfgs[1])
    np.testing.assert_array_equal(tp.n(got.status), np.asarray(want.status))
    for mask in (status == 0, status == 1, np.zeros(64, bool),
                 np.ones(64, bool)):
        np.testing.assert_array_equal(
            tp.n(ts_._rank_to_index(tp.t(mask))),
            np.asarray(js._rank_to_index(jnp.asarray(mask))))


def test_seed_and_grid_selection(ref, cfgs):
    from coslam_tpu.slam import steps as js
    from coslam_tpu.slam.classify import point_obs_table as jpot
    from coslam_torch.slam import steps as ts_
    from coslam_torch.slam.classify import point_obs_table as tpot
    st = ref["snaps"][27][0]
    jK, jkc, tK, tkc = kmats()
    kc = np.array([[-0.2, 0.05, 1e-3, -5e-4, 0.0]], np.float32)
    tr = st.tracks
    for frame in (9, 27):
        want = js.seed_tracks(jtree(tr), jnp.asarray(tr.pos),
                              jnp.asarray(tr.valid), jnp.asarray(tr.mpt),
                              jK, jnp.asarray(kc), jnp.asarray(frame))
        got = ts_.seed_tracks(ttree(tr), tp.t(tr.pos), tp.t(tr.valid),
                              tp.t(tr.mpt), tK, tp.t(kc), frame)
        for f in want._fields:
            np.testing.assert_allclose(
                tp.n(getattr(got, f)).astype(np.float64),
                np.asarray(getattr(want, f)).astype(np.float64),
                atol=1e-4, err_msg=f)
    sel_j = js.choose_grid_features(jtree(tr), jtree(st.mappts),
                                    (tp.H, tp.W), cfgs[0])
    sel_t = ts_.choose_grid_features(ttree(tr), ttree(st.mappts),
                                     (tp.H, tp.W), cfgs[1])
    assert np.asarray(sel_j).sum() > 20
    np.testing.assert_array_equal(tp.n(sel_t), np.asarray(sel_j))
    P = st.mappts.xyz.shape[0]
    for a, b in zip(jpot(jtree(tr), P), tpot(ttree(tr), P)):
        np.testing.assert_array_equal(tp.n(b), np.asarray(a))


def test_fuse_close_kill_mask(ref, cfgs):
    """The duplicate-unification kill mask on a real map, with a few
    planted near-duplicates of older points."""
    from coslam_tpu.slam.merge import _fuse_close_kill_mask as jkill
    from coslam_torch.slam.merge import _fuse_close_kill_mask as tkill
    from coslam_torch.slam.merge import fuse_close_points
    st = ref["snaps"][27][0]
    mp = st.mappts
    alive = np.nonzero(mp.status == 1)[0]
    free = np.nonzero(mp.status == 0)[0]
    xyz, ncc, ff = mp.xyz.copy(), mp.ncc.copy(), mp.first_frame.copy()
    fields = {f: getattr(mp, f).copy() for f in mp._fields}
    for src, dst in zip(alive[:5], free[:5]):
        for f in fields:
            fields[f][dst] = fields[f][src]
        fields["xyz"][dst] = xyz[src] + 1e-3
        fields["first_frame"][dst] = ff[src] + 1
    mp = mp._replace(**fields)
    want = np.asarray(jkill(jtree(mp), jnp.asarray(st.R), jnp.asarray(st.t),
                            block=256))
    got = tp.n(tkill(ttree(mp), tp.t(st.R), tp.t(st.t), block=256))
    np.testing.assert_array_equal(got, want)
    assert got[free[:5]].all()
    tst = ttree(st._replace(mappts=mp))
    out, n = fuse_close_points(tst, cfgs[1])
    assert n == int(want.sum())
    assert (tp.n(out.mappts.status)[want] == 2).all()


# ---------------------------------------------------------- BA chain ----

def test_keyframe_and_ba_chain(ref, cfgs):
    """add_keyframe -> build_ba_table -> bundle_adjust_table ->
    apply_ba_table_results from snapshot 27 (a full six-keyframe window
    with free cameras)."""
    from coslam_tpu.slam import steps as js
    from coslam_tpu.solvers.ba import bundle_adjust_table as jba
    from coslam_torch.slam import steps as ts_
    from coslam_torch.solvers.ba import bundle_adjust_table as tba
    st = ref["snaps"][27][0]
    jcfg, tcfg = cfgs
    jK, _, tK, _ = kmats()
    jst = jtree(st)
    jkf = js.add_keyframe(jst)
    tkf = ts_.add_keyframe(ttree(st))
    for f in jkf._fields:
        np.testing.assert_array_equal(tp.n(getattr(tkf, f)),
                                      np.asarray(getattr(jkf, f)), f)
    base = tp.to_numpy(jst._replace(kfs=jkf))
    assert int(base.kfs.n) >= jcfg.cap.ba_window
    jprob, jring, jok = js.build_ba_table(jtree(base), jK, jcfg)
    tprob, tring, tok = ts_.build_ba_table(ttree(base), tK, tcfg)
    np.testing.assert_array_equal(tp.n(tring), np.asarray(jring))
    np.testing.assert_array_equal(tp.n(tok), np.asarray(jok))
    for f in jprob._fields:
        np.testing.assert_array_equal(tp.n(getattr(tprob, f)),
                                      np.asarray(getattr(jprob, f)), f)
    assert not np.asarray(jprob.cam_fixed).all()
    p = jcfg.p
    kw = dict(max_err=p.max_err, max_iter=p.ba_max_iter,
              inner_iter=p.ba_inner_iter)
    jres = jba(jprob, **kw)
    tres = tba(tprob, **kw)
    np.testing.assert_allclose(tp.n(tres.R), np.asarray(jres.R), atol=1e-3)
    np.testing.assert_allclose(tp.n(tres.t), np.asarray(jres.t), atol=1e-3)
    obs2 = np.asarray(jprob.obs_valid).sum(0) >= 2
    np.testing.assert_allclose(tp.n(tres.X)[obs2], np.asarray(jres.X)[obs2],
                               atol=1e-2)
    jo, to = np.asarray(jres.obs_outlier), tp.n(tres.obs_outlier)
    assert (jo != to).sum() <= 3
    # write-back, each package applying its own solve to the same state
    jnew = js.apply_ba_table_results(jtree(base), jres, jring, jok, jcfg)
    tnew = ts_.apply_ba_table_results(ttree(base), tres, tring, tok, tcfg)
    np.testing.assert_allclose(tp.n(tnew.R), np.asarray(jnew.R), atol=1e-3)
    np.testing.assert_allclose(tp.n(tnew.t), np.asarray(jnew.t), atol=1e-3)
    np.testing.assert_allclose(tp.n(tnew.kfs.R), np.asarray(jnew.kfs.R),
                               atol=1e-3)
    np.testing.assert_allclose(tp.n(tnew.pose_hist_t),
                               np.asarray(jnew.pose_hist_t), atol=1e-3)
    P = st.mappts.xyz.shape[0]
    moved = obs2[:P]
    np.testing.assert_allclose(tp.n(tnew.mappts.xyz)[moved],
                               np.asarray(jnew.mappts.xyz)[moved], atol=1e-2)
    js_, ts_s = np.asarray(jnew.mappts.status), tp.n(tnew.mappts.status)
    assert (js_ != ts_s).sum() <= 2
    # the same write-back of the SAME solve agrees to float32 rounding
    tsame = ts_.apply_ba_table_results(
        ttree(base), ttree(tp.to_numpy(jres)), tring, tok, tcfg)
    np.testing.assert_allclose(tp.n(tsame.R), np.asarray(jnew.R), atol=1e-5)
    np.testing.assert_array_equal(tp.n(tsame.mappts.status), js_)


# ------------------------------------------------------- fused step ----

def test_frame_step_over_three_frames(ref, cfgs):
    """Three fused steps (frames 13-15) from snapshot 12, each package
    building its own pyramids from the same images."""
    from coslam_tpu.slam.fused import frame_step as jstep
    from coslam_tpu.slam.fused import pack_stats as jpack
    from coslam_torch.slam.fused import frame_step as tstep
    from coslam_torch.slam.fused import pack_stats, unpack_stats
    st, pyr_prev = ref["snaps"][12]
    jK, jkc, tK, tkc = kmats()
    js_, jp = jtree(st), jtree(pyr_prev)
    ts_, tpyr = ttree(st), tp.pyramid_to_torch(pyr_prev)
    D = st.kfs.dyn_xyz.shape[1]
    for f in (13, 14, 15):
        img = ref["frames"][f][None]
        js_, jp, jfs = jstep(js_, jp, jnp.asarray(img), jK, jkc, cfgs[0])
        ts_, tpyr, tfs = tstep(ts_, tpyr, tp.t(img), tK, tkc, cfgs[1])
        jv, tv = np.asarray(jpack(jfs)), tp.n(pack_stats(tfs))
        assert jv.shape == tv.shape
        ju, tu = unpack_stats(jv, 1, D), unpack_stats(tv, 1, D)
        assert int(tu.n_tracked[0]) == int(tp.n(tfs.n_tracked)[0])
        assert abs(int(tu.n_tracked[0]) - int(ju.n_tracked[0])) <= 3
        assert abs(int(tu.n_inliers[0]) - int(ju.n_inliers[0])) <= 3
        assert abs(int(tu.n_mapped[0]) - int(ju.n_mapped[0])) <= 3
        # three chained steps: a feature flipping at a gate moves the
        # next IRLS solve, so the gap grows frame by frame; 5e-3 is a
        # sixth of the camera's travel per frame here (~0.03)
        np.testing.assert_allclose(tu.R, ju.R, atol=2e-3)
        np.testing.assert_allclose(tu.t, ju.t, atol=5e-3)
        np.testing.assert_array_equal(tu.dyn_ids, ju.dyn_ids)
    assert int(ts_.frame) == int(js_.frame) == 15
    assert_tracks_close(js_.tracks, ts_.tracks, max_flips=8, pos_tol=1e-2)


# -------------------------------------------------------- end to end ----

@pytest.fixture(scope="module")
def port_run(ref):
    from coslam_torch.config import small_test_config
    from coslam_torch.slam.pipeline import CoSlamEngine
    eng = CoSlamEngine(small_test_config(1, tp.H, tp.W), tp.KMAT, tp.KC,
                       device="cpu")
    for f in range(F):
        eng.process_frame(ref["frames"][f][None])
    return eng


def test_end_to_end_bootstrap_and_keyframes(ref, port_run):
    eng = port_run
    assert eng.bootstrapped
    assert tp.boot_frame(eng.stats_log) == ref["boot_frame"] is not None
    a, b = eng.kf_frames, ref["kf_frames"]
    assert abs(len(a) - len(b)) <= 1
    assert len(set(a) ^ set(b)) <= 2, (a, b)
    assert eng.ba_runs >= 1
    assert len(eng.stats_log) == F


def test_end_to_end_trajectory_band(ref, port_run):
    from coslam_torch.io.ate import ate_rmse, camera_centers, umeyama
    Rs, ts = port_run.trajectory(0, correct=True)
    assert Rs.shape == (F, 3, 3) and ts.shape == (F, 3)
    assert np.isfinite(Rs).all() and np.isfinite(ts).all()
    ate = ate_rmse(Rs, ts, ref["Rs_gt"], ref["ts_gt"])
    assert ate < 0.20, ate
    c_port = camera_centers(Rs, ts)
    c_ref = camera_centers(*ref["traj"])
    s, R, t = umeyama(c_port, c_ref)
    aligned = (s * (R @ c_port.T)).T + t
    gap = np.linalg.norm(aligned - c_ref, axis=-1)
    path = np.linalg.norm(np.diff(c_ref, axis=0), axis=-1).sum()
    assert gap.max() < 0.05 * max(path, 1.0), gap


def test_end_to_end_map(port_run):
    ids, xyz, cov = port_run.map_points()
    assert len(ids) > 60
    assert np.isfinite(xyz).all() and np.isfinite(cov).all()
    assert (np.abs(xyz[:, :2]) < 15).mean() > 0.95
    errs = [s["med_err"][0] for s in port_run.stats_log if "med_err" in s]
    assert np.nanmedian(errs) < 0.5
