"""Module parity of the multi-camera slice: ``coslam_torch`` against
``coslam_tpu`` at small_test_config(2, 150, 200), on the JAX package's
20-frame two-camera rig (tests/test_pipeline_multicam.py's scene) and on
seeded numpy inputs.

The JAX engine runs once (module fixture) and leaves numpy snapshots of
its state after frames 0 (the wide-baseline bootstrap), 12 and 18 (six
keyframes). Every stage test starts both packages from one snapshot and
the same pyramids, so only the stage itself is compared.

Tolerances, and why:
- integer outputs on identical inputs (matches, votes, window counts,
  shared-point counts, groups, chained tracks) are equal;
- NCC blocks to 1e-4: the JAX package cuts one image's windows with bf16
  hi/lo one-hot products (~2^-16 relative), the port copies pixels;
- float solves (BA, joint pose) to 1e-4..1e-3 of their scale
  (float32, sums reordered, segment sums by ``index_add_``);
- classification on identical input state: at most 0.5% of the alive
  points (one at least) may change type or status differently (a float
  gate on a point that sits on it);
- RANSAC (map init) draws from ``jax.random`` in the JAX package and
  from a seeded ``torch.Generator`` in the port: compared by consensus
  size and pose error;
- the fused step over three chained frames: rotations to 2e-3 and
  translations to 5e-3 (a feature flipping at a gate moves the next
  solve), counts within 3.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_parity as tp

C = 2
F = 20
SNAPS = (0, 12, 18)


@pytest.fixture(scope="module")
def ref():
    frames, Rs, ts = tp.render_rig_frames(C, F)
    run = tp.run_jax_engine(frames, snapshots=SNAPS)
    run.update(frames=frames, Rs_gt=Rs, ts_gt=ts)
    return run


@pytest.fixture(scope="module")
def cfgs():
    from coslam_tpu.config import small_test_config as jc
    from coslam_torch.config import small_test_config as tc
    return jc(C, tp.H, tp.W), tc(C, tp.H, tp.W)


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def ttree(tree):
    from coslam_torch.slam.state import state_from_numpy
    return state_from_numpy(tree, "cpu")


def kmats():
    K, kc = tp.kmats(C)
    return jnp.asarray(K), jnp.asarray(kc), tp.t(K), tp.t(kc)


def jpyr(img):
    from coslam_tpu.ops import build_pyramid
    return tp.to_numpy(build_pyramid(jnp.asarray(img), 3))


def band(n_alive):
    """Entries allowed to differ where a float gate decides them."""
    return max(1, int(0.005 * n_alive))


# ------------------------------------------------------------- ops -----

def test_render_rig_with_moving_quad():
    """The port's renderer with a moving quad and the rig helper against
    the JAX package's (same textures from the same numpy generator)."""
    from coslam_tpu.io import synthetic as js
    from coslam_torch.io import synthetic as ts
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    mk = dict(center0=np.array([-1.0, 0.3, 12.0], np.float32),
              velocity=np.array([0.5, 0.0, 0.0], np.float32),
              eu=np.array([2.2, 0, 0], np.float32),
              ev=np.array([0, 2.2, 0], np.float32))
    qj = js.MovingQuad(tex=js.make_texture(rng_j), **mk)
    qt = ts.MovingQuad(tex=ts.make_texture(rng_t), **mk)
    pj, pt = js.make_room(rng_j, size=10.0), ts.make_room(rng_t, size=10.0)
    rj, rt = js.multi_cam_rig(3, 0.9), ts.multi_cam_rig(3, 0.9)
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(a, b)
    Rs, tt = ts.rig_sequence(3, 4, baseline=0.9, forward=0.05)
    want = np.asarray(js.render_sequence(pj, tp.KMAT[0], Rs[1], tt[1], 60,
                                         80, quads=[qj]))
    got = tp.n(ts.render_sequence(pt, tp.KMAT[0], Rs[1], tt[1], 60, 80,
                                  quads=[qt], device="cpu"))
    np.testing.assert_allclose(got, want, atol=2e-2)
    assert np.abs(want[3] - want[0]).max() > 50      # the quad moved
    one = tp.n(ts.render(pt, tp.KMAT[0], Rs[1, 2], tt[1, 2], 60, 80,
                         quads=[qt], frame=2, device="cpu"))
    np.testing.assert_allclose(one, got[2], atol=1e-4)


def test_extract_ncc_blocks_and_scores(rng):
    from coslam_tpu.ops import ncc as jn
    from coslam_torch.ops import ncc as tn
    img = tp.smooth_texture(rng, 70, 90)[0]
    img[10:30, 40:60] = 80.0                        # a textureless patch
    pos = rng.uniform([-3, -3], [93, 73], (40, 2)).astype(np.float32)
    pos[:4] = [[50, 20], [5.0, 5.0], [84.2, 20.7], [12.5, 33.25]]
    jb, jo = jn.extract_ncc_blocks(jnp.asarray(img), jnp.asarray(pos), 5)
    tb, to = tn.extract_ncc_blocks(tp.t(img), tp.t(pos), 5)
    np.testing.assert_array_equal(tp.n(to), np.asarray(jo))
    assert 10 < int(np.asarray(jo).sum()) < 40 and not np.asarray(jo)[0]
    np.testing.assert_allclose(tp.n(tb), np.asarray(jb), atol=1e-4)
    # score matrices on identical blocks
    b = np.asarray(jb)
    va, vb = np.asarray(jo), np.roll(np.asarray(jo), 3)
    want = np.asarray(jn.ncc_score_matrix(jnp.asarray(b), jnp.asarray(b[::-1]),
                                          jnp.asarray(va), jnp.asarray(vb)))
    got = tp.n(tn.ncc_score_matrix(tp.t(b), tp.t(b[::-1]), tp.t(va),
                                   tp.t(vb)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (got == tn.NCC_INVALID).sum() == (want == jn.NCC_INVALID).sum() > 0


@pytest.mark.parametrize("radius", [3, 7])
def test_extract_ncc_blocks_radius(rng, radius):
    """Other block sizes than the engine's default: the same windows, the
    same border and texture rejections."""
    from coslam_tpu.ops import ncc as jn
    from coslam_torch.ops import ncc as tn
    img = tp.smooth_texture(rng, 60, 80)[0]
    img[5:25, 50:75] = 30.0
    pos = rng.uniform([-2, -2], [82, 62], (50, 2)).astype(np.float32)
    pos[:2] = [[62.0, 15.0], [radius, radius]]
    jb, jo = jn.extract_ncc_blocks(jnp.asarray(img), jnp.asarray(pos), radius)
    tb, to = tn.extract_ncc_blocks(tp.t(img), tp.t(pos), radius)
    assert tp.n(tb).shape == (50, (2 * radius + 1) ** 2)
    np.testing.assert_array_equal(tp.n(to), np.asarray(jo))
    assert not np.asarray(jo)[0] and np.asarray(jo).sum() > 20
    np.testing.assert_allclose(tp.n(tb), np.asarray(jb), atol=1e-4)


@pytest.mark.parametrize("rounds", [1, 4, 8])
def test_greedy_mutual_match(rng, rounds):
    """Equal assignments on the same score matrix, with repeated scores
    (first-maximum ties) and invalid rows and columns."""
    from coslam_tpu.ops.matching import greedy_mutual_match as jm
    from coslam_torch.ops.matching import greedy_mutual_match as tm
    s = np.round(rng.uniform(-1, 1, (60, 45)), 1).astype(np.float32)
    s[::7] = -2.0
    s[:, ::5] = -2.0
    want = jm(jnp.asarray(s), min_score=0.3, rounds=rounds)
    got = tm(tp.t(s), min_score=0.3, rounds=rounds)
    np.testing.assert_array_equal(tp.n(got.a_to_b), np.asarray(want.a_to_b))
    np.testing.assert_array_equal(tp.n(got.score), np.asarray(want.score))
    assert (np.asarray(want.a_to_b) >= 0).sum() > 5


def test_guided_match(rng):
    """Epipolar- and disparity-gated matching on identical blocks."""
    from coslam_tpu.ops import matching as jm
    from coslam_torch.ops import matching as tm
    N, S = 80, 121
    ba = rng.standard_normal((N, S)).astype(np.float32)
    bb = np.roll(ba, 7, axis=0) + 0.4 * rng.standard_normal((N, S)) \
        .astype(np.float32)
    for b in (ba, bb):
        b -= b.mean(1, keepdims=True)
        b /= np.linalg.norm(b, axis=1, keepdims=True)
    va, vb = rng.random(N) > 0.1, rng.random(N) > 0.1
    pa = rng.uniform(0, 200, (N, 2)).astype(np.float32)
    pb = np.roll(pa, 7, axis=0) + rng.normal(0, 2, (N, 2)).astype(np.float32)
    F = rng.standard_normal((3, 3)).astype(np.float32) * 1e-3
    np.testing.assert_allclose(
        tp.n(tm.epipolar_distance_matrix(tp.t(F), tp.t(pa), tp.t(pb))),
        np.asarray(jm.epipolar_distance_matrix(jnp.asarray(F),
                                               jnp.asarray(pa),
                                               jnp.asarray(pb))),
        rtol=1e-4, atol=1e-3)
    for kw in (dict(), dict(max_disparity=8.0), dict(F=F, max_epi=40.0)):
        want = jm.guided_match(*(jnp.asarray(a) for a in (ba, bb, va, vb,
                                                          pa, pb)),
                               **{k: jnp.asarray(v) if k == "F" else v
                                  for k, v in kw.items()})
        got = tm.guided_match(*(tp.t(a) for a in (ba, bb, va, vb, pa, pb)),
                              **{k: tp.t(v) if k == "F" else v
                                 for k, v in kw.items()})
        np.testing.assert_array_equal(tp.n(got.a_to_b),
                                      np.asarray(want.a_to_b), str(kw))
        assert (np.asarray(want.a_to_b) >= 0).sum() > 10, kw


# -------------------------------------------------------- geometry -----

def test_hull_area_masked(rng):
    from coslam_tpu.geometry.hull import hull_area_masked as jh
    from coslam_torch.geometry.hull import hull_area_masked as th
    x = rng.uniform(0, 200, (300, 3, 3)).astype(np.float32)
    y = rng.uniform(0, 150, (300, 3, 3)).astype(np.float32)
    m = rng.random((300, 3, 3)) < np.array([0.5, 0.02, 0.0])[None, :, None]
    want = np.asarray(jh(jnp.asarray(x), jnp.asarray(y), jnp.asarray(m)))
    got = tp.n(th(tp.t(x), tp.t(y), tp.t(m)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)
    assert (want[2] == 0).all() and (want[0] > 1e4).all()
    # a square: exact
    sq = np.array([[0, 0], [10, 0], [10, 10], [0, 10], [5, 5]], np.float32)
    a = th(tp.t(sq[:, 0]), tp.t(sq[:, 1]), torch.ones(5, dtype=torch.bool))
    assert abs(float(a) - 100.0) < 1e-3


def test_bundle_adjust_list(rng):
    """The observation-list BA on a 3-camera problem with noise, outliers,
    a frozen camera and frozen points: the same solution and flags."""
    from coslam_tpu.solvers import ba as jb
    from coslam_torch.solvers import ba as tb
    from coslam_torch.geometry.se3 import so3_exp_np
    M, P = 3, 60
    K = np.repeat(tp.KMAT, M, 0)
    R = np.stack([so3_exp_np(np.array([0, 0.05 * m, 0])) for m in range(M)])
    t = np.array([[-0.5 * m, 0, 0] for m in range(M)], np.float32)
    X = rng.uniform([-3, -2, 5], [3, 2, 9], (P, 3)).astype(np.float32)
    cam = np.tile(np.arange(M), P).astype(np.int32)
    pt = np.repeat(np.arange(P), M).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", R[cam], X[pt]) + t[cam]
    px = Xc[:, :2] / Xc[:, 2:] * 180.0 + np.array([100, 75])
    px = (px + rng.normal(0, 0.5, px.shape)).astype(np.float32)
    px[::17] += 40.0                                   # outliers
    valid = rng.random(M * P) > 0.1
    R0 = np.stack([so3_exp_np(rng.normal(0, 0.01, 3)) @ r for r in R])
    t0 = (t + rng.normal(0, 0.03, t.shape)).astype(np.float32)
    X0 = (X + rng.normal(0, 0.05, X.shape)).astype(np.float32)
    cam_fixed = np.array([True, False, False])
    point_fixed = np.arange(P) % 9 == 0
    args = (K, R0.astype(np.float32), t0, X0, cam, pt, px, valid, cam_fixed,
            point_fixed)
    want = jb.bundle_adjust(jb.BAProblem(*(jnp.asarray(a) for a in args)),
                            max_err=10.0, max_iter=3, inner_iter=15)
    got = tb.bundle_adjust(tb.BAProblem(*(tp.t(a) for a in args)),
                           max_err=10.0, max_iter=3, inner_iter=15)
    np.testing.assert_allclose(tp.n(got.R), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(tp.n(got.t), np.asarray(want.t), atol=1e-3)
    np.testing.assert_array_equal(tp.n(got.X)[point_fixed], X0[point_fixed])
    out = np.asarray(want.obs_outlier)
    np.testing.assert_array_equal(tp.n(got.obs_outlier), out)
    assert out.sum() >= 3
    # points fixed by three inlier views to 1e-3; the others move along
    # weakly fixed rays (1% of depth), their reprojections agree to 0.02 px
    three = np.bincount(pt[valid & ~out], minlength=P) >= 3
    np.testing.assert_allclose(tp.n(got.X)[three], np.asarray(want.X)[three],
                               atol=1e-3)
    np.testing.assert_allclose(tp.n(got.X), np.asarray(want.X),
                               atol=1e-2 * 9)
    inl = valid & ~out
    np.testing.assert_allclose(tp.n(got.obs_err)[inl],
                               np.asarray(want.obs_err)[inl], atol=2e-2)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-3)


# --------------------------------------------------- stages at C = 2 ---

@pytest.fixture(scope="module")
def tracked13(ref, cfgs):
    """Frame 13 from snapshot 12: the JAX advance_tracks + pose_update +
    push_pose_history output, and the pyramids both packages share."""
    from coslam_tpu.slam import steps as js
    st, pyr_prev = ref["snaps"][12]
    jK, jkc, _, _ = kmats()
    pyr_cur = jpyr(ref["frames"][13])
    jst = jtree(st)
    tracks = js.advance_tracks(jtree(pyr_prev), jtree(pyr_cur), jst.tracks,
                               jK, jkc, jst.frame + 1, cfgs[0])
    jst = jst._replace(tracks=tracks, frame=jst.frame + 1)
    adv = tp.to_numpy(jst)
    out = js.pose_update(jst, jK, jkc, (tp.H, tp.W), cfgs[0])
    jst = js.push_pose_history(jst._replace(R=out.R, t=out.t,
                                            tracks=out.tracks,
                                            mappts=out.mappts))
    return adv, tp.to_numpy(jst), pyr_prev, pyr_cur


def test_steps_two_cameras(ref, cfgs, tracked13):
    """advance_tracks, pose_update and push_pose_history at C = 2 (the
    bands of tests/test_torch_engine.py)."""
    from coslam_tpu.slam import steps as js
    from coslam_torch.slam import steps as ts_
    st, pyr_prev = ref["snaps"][12]
    adv, posed, _, pyr_cur = tracked13
    jK, jkc, tK, tkc = kmats()
    tst = ttree(st)
    got = ts_.advance_tracks(tp.pyramid_to_torch(pyr_prev),
                             tp.pyramid_to_torch(pyr_cur), tst.tracks, tK,
                             tkc, tst.frame + 1, cfgs[1])
    tp.assert_tracks_close(adv.tracks, got, max_flips=4)
    jo = js.pose_update(jtree(adv), jK, jkc, (tp.H, tp.W), cfgs[0])
    to = ts_.pose_update(ttree(adv), tK, tkc, (tp.H, tp.W), cfgs[1])
    np.testing.assert_allclose(tp.n(to.R), np.asarray(jo.R), atol=1e-4)
    np.testing.assert_allclose(tp.n(to.t), np.asarray(jo.t), atol=1e-4)
    assert (np.abs(tp.n(to.n_inliers) - np.asarray(jo.n_inliers)) <= 2).all()
    assert (np.asarray(jo.n_inliers) > 40).all()
    assert (np.asarray(jo.tracks.mpt) != tp.n(to.tracks.mpt)).sum() <= 2
    np.testing.assert_array_equal(tp.n(to.mappts.last_obs),
                                  np.asarray(jo.mappts.last_obs))
    np.testing.assert_array_equal(tp.n(to.mappts.owner),
                                  np.asarray(jo.mappts.owner))
    pushed = ts_.push_pose_history(ttree(adv)._replace(R=tp.t(posed.R),
                                                       t=tp.t(posed.t)))
    np.testing.assert_array_equal(tp.n(pushed.pose_hist_R),
                                  posed.pose_hist_R)
    np.testing.assert_array_equal(tp.n(pushed.pose_hist_t),
                                  posed.pose_hist_t)


def test_new_map_points_two_cameras(ref, cfgs):
    from coslam_tpu.slam import steps as js
    from coslam_torch.slam import steps as ts_
    st, pyr = ref["snaps"][18]
    mpt = st.tracks.mpt.copy()
    cand = (mpt >= 0) & (st.tracks.age >= 6)
    assert cand.sum() > 60
    mpt[cand] = -1
    st = st._replace(tracks=st.tracks._replace(mpt=mpt))
    jK, jkc, tK, tkc = kmats()
    jm, jtr, jn = js.new_map_points(jtree(st), jtree(pyr), jK, jkc, cfgs[0])
    tm, ttr, tn = ts_.new_map_points(ttree(st), tp.pyramid_to_torch(pyr),
                                     tK, tkc, cfgs[1])
    assert int(jn) > 10
    assert abs(int(tn) - int(jn)) <= 2
    assert (np.asarray(jtr.mpt) != tp.n(ttr.mpt)).sum() <= 2
    ja, ta = np.asarray(jm.status), tp.n(tm.status)
    same = (ja == ta) & (ja == 1)
    # 2e-3 of the scene depth: a point on a short baseline moves along its
    # weakly fixed ray with the float32 rounding of the chain solve
    depth = np.median(np.abs(np.asarray(jm.xyz)[same, 2]))
    np.testing.assert_allclose(tp.n(tm.xyz)[same], np.asarray(jm.xyz)[same],
                               atol=2e-3 * depth)
    for f in ("gen", "first_frame", "owner", "ptype", "ncc_valid"):
        np.testing.assert_array_equal(tp.n(getattr(tm, f))[same],
                                      np.asarray(getattr(jm, f))[same],
                                      err_msg=f)


def test_keyframe_ba_and_fusion_two_cameras(ref, cfgs):
    """add_keyframe -> build_ba_table -> bundle_adjust_table ->
    apply_ba_table_results from snapshot 18 (a full window, free cameras
    of both rigs' cameras), and the duplicate-fusion kill mask."""
    from coslam_tpu.slam import steps as js
    from coslam_tpu.slam.merge import _fuse_close_kill_mask as jkill
    from coslam_tpu.solvers.ba import bundle_adjust_table as jba
    from coslam_torch.slam import steps as ts_
    from coslam_torch.slam.merge import _fuse_close_kill_mask as tkill
    from coslam_torch.slam.merge import fuse_close_points
    from coslam_torch.solvers.ba import bundle_adjust_table as tba
    st = ref["snaps"][18][0]
    jcfg, tcfg = cfgs
    jK, _, tK, _ = kmats()
    jkf = js.add_keyframe(jtree(st))
    tkf = ts_.add_keyframe(ttree(st))
    for f in jkf._fields:
        np.testing.assert_array_equal(tp.n(getattr(tkf, f)),
                                      np.asarray(getattr(jkf, f)), f)
    base = tp.to_numpy(jtree(st)._replace(kfs=jkf))
    jprob, jring, jok = js.build_ba_table(jtree(base), jK, jcfg)
    tprob, tring, tok = ts_.build_ba_table(ttree(base), tK, tcfg)
    for f in jprob._fields:
        np.testing.assert_array_equal(tp.n(getattr(tprob, f)),
                                      np.asarray(getattr(jprob, f)), f)
    assert tp.n(tprob.cam_fixed).shape == (jcfg.cap.ba_window * C,)
    assert not np.asarray(jprob.cam_fixed).all()
    p = jcfg.p
    kw = dict(max_err=p.max_err, max_iter=p.ba_max_iter,
              inner_iter=p.ba_inner_iter)
    jres, tres = jba(jprob, **kw), tba(tprob, **kw)
    np.testing.assert_allclose(tp.n(tres.R), np.asarray(jres.R), atol=1e-3)
    np.testing.assert_allclose(tp.n(tres.t), np.asarray(jres.t), atol=1e-3)
    jnew = js.apply_ba_table_results(jtree(base), jres, jring, jok, jcfg)
    tnew = ts_.apply_ba_table_results(ttree(base), tres, tring, tok, tcfg)
    np.testing.assert_allclose(tp.n(tnew.R), np.asarray(jnew.R), atol=1e-3)
    np.testing.assert_allclose(tp.n(tnew.t), np.asarray(jnew.t), atol=1e-3)
    np.testing.assert_allclose(tp.n(tnew.kfs.t), np.asarray(jnew.kfs.t),
                               atol=1e-3)
    assert (np.asarray(jnew.mappts.status)
            != tp.n(tnew.mappts.status)).sum() <= 2
    want = np.asarray(jkill(jtree(st.mappts), jnp.asarray(st.R),
                            jnp.asarray(st.t), block=256))
    np.testing.assert_array_equal(
        tp.n(tkill(ttree(st.mappts), tp.t(st.R), tp.t(st.t), block=256)),
        want)
    out, n = fuse_close_points(ttree(st), tcfg)
    assert n == int(want.sum())
    assert (tp.n(out.mappts.status)[want] == 2).all()


# ------------------------------------------------------ classify -------

def _perturbed(st):
    """Snapshot 18 with movers planted: a tenth of the alive static points
    shifted in space (a stale stored position), half of them already one
    moved vote in, and a few features voted dynamic."""
    mp, tr = st.mappts, st.tracks
    alive = np.nonzero((mp.status == 1) & (mp.ptype == 0))[0]
    mv = alive[::10]
    xyz = mp.xyz.copy()
    xyz[mv] += np.array([0.6, 0.0, 0.0], np.float32)
    moved = mp.moved_votes.copy()
    moved[mv[::2]] = 1
    votes = tr.dyn_votes.copy()
    votes[:, 5:40:6] = 3
    return st._replace(mappts=mp._replace(xyz=xyz, moved_votes=moved),
                       tracks=tr._replace(dyn_votes=votes))


def test_detect_dynamic_features(ref, cfgs):
    from coslam_tpu.slam.classify import detect_dynamic_features as jd
    from coslam_torch.slam.classify import detect_dynamic_features as td
    st = ref["snaps"][18][0]
    jK, _, tK, _ = kmats()
    # a 3.4-degree pose glitch on camera 1 (~11 px at f = 180) makes its
    # features violate the epipolar constraint against their history
    from coslam_torch.geometry.se3 import so3_exp_np
    R = st.R.copy()
    R[1] = so3_exp_np(np.array([0.0, 0.06, 0.0])) @ R[1]
    st = st._replace(R=R)
    want = np.asarray(jd(jtree(st), jK, cfgs[0]).tracks.dyn_votes)
    got = tp.n(td(ttree(st), tK, cfgs[1]).tracks.dyn_votes)
    np.testing.assert_array_equal(got, want)
    assert (want[1] > st.tracks.dyn_votes[1]).sum() > 20


def test_windowed_static_err(ref, cfgs):
    """Integer window counts: equal (the port sums them by index_add_)."""
    from coslam_tpu.slam.classify import _windowed_static_err as jw
    from coslam_torch.slam.classify import _windowed_static_err as tw
    st = _perturbed(ref["snaps"][18][0])
    jK, _, tK, _ = kmats()
    jc, jg = jw(jtree(st), jK, cfgs[0])
    tc, tg = tw(ttree(st), tK, cfgs[1])
    np.testing.assert_array_equal(tp.n(tc), np.asarray(jc))
    np.testing.assert_array_equal(tp.n(tg), np.asarray(jg))
    assert (np.asarray(jc) > 0).sum() > 50
    assert (np.asarray(jg) < np.asarray(jc)).sum() > 5


def test_classify_map_points(ref, cfgs):
    from coslam_tpu.slam.classify import classify_map_points as jcl
    from coslam_torch.slam.classify import classify_map_points as tcl
    st = _perturbed(ref["snaps"][18][0])
    jK, _, tK, _ = kmats()
    jo, to = jcl(jtree(st), jK, cfgs[0]), tcl(ttree(st), tK, cfgs[1])
    n_alive = int((st.mappts.status == 1).sum())
    lim = band(n_alive)
    for f in ("ptype", "status", "bad_votes", "moved_votes", "ncc_valid"):
        d = (np.asarray(getattr(jo.mappts, f))
             != tp.n(getattr(to.mappts, f))).any(axis=-1) \
            if f == "ncc_valid" else \
            np.asarray(getattr(jo.mappts, f)) != tp.n(getattr(to.mappts, f))
        assert d.sum() <= lim, (f, d.sum(), lim)
    assert (np.asarray(jo.tracks.mpt) != tp.n(to.tracks.mpt)).sum() <= lim
    for f in ("n_static", "n_dynamic", "n_false"):
        assert abs(int(getattr(to, f)) - int(getattr(jo, f))) <= lim, f
    assert int(jo.n_dynamic) >= 5 and int(jo.n_static) > 50
    jt, tt = np.asarray(jo.mappts.ptype), tp.n(to.mappts.ptype)
    dyn = (jt == 1) & (tt == 1)
    np.testing.assert_allclose(tp.n(to.mappts.xyz)[dyn],
                               np.asarray(jo.mappts.xyz)[dyn], atol=1e-2)
    np.testing.assert_allclose(tp.n(to.mappts.cov)[dyn],
                               np.asarray(jo.mappts.cov)[dyn],
                               rtol=1e-2, atol=1e-5)


# ------------------------------------------------------ intercam -------

def test_intercam_map_group(ref, cfgs):
    """From snapshot 12 with the mature mapped features of both cameras
    unbound: the same chained matches, allocations and points."""
    from coslam_tpu.slam.intercam import intercam_map_group as jmap
    from coslam_torch.slam.intercam import intercam_map_group as tmap
    st, pyr = ref["snaps"][12]
    mpt = st.tracks.mpt.copy()
    mpt[(mpt >= 0) & (st.tracks.age >= 4)] = -1
    st = st._replace(tracks=st.tracks._replace(mpt=mpt))
    jK, jkc, tK, tkc = kmats()
    jm, jtr, jn = jmap(jtree(st), jtree(pyr), jK, jkc, (0, 1), cfgs[0])
    tm, ttr, tn = tmap(ttree(st), tp.pyramid_to_torch(pyr), tK, tkc, (0, 1),
                       cfgs[1])
    assert int(tn) == int(jn) > 20
    np.testing.assert_array_equal(tp.n(ttr.mpt), np.asarray(jtr.mpt))
    for f in ("status", "ptype", "gen", "owner", "first_frame",
              "ncc_valid"):
        np.testing.assert_array_equal(tp.n(getattr(tm, f)),
                                      np.asarray(getattr(jm, f)), f)
    new = np.asarray(jm.status) != st.mappts.status
    depth = np.median(np.abs(np.asarray(jm.xyz)[new, 2]))
    np.testing.assert_allclose(tp.n(tm.xyz)[new], np.asarray(jm.xyz)[new],
                               atol=1e-3 * depth)
    np.testing.assert_allclose(tp.n(tm.ncc), np.asarray(jm.ncc), atol=1e-5)


def test_alloc_slots(rng):
    """Free-list allocation: wanted rows take the free slots in order; rows
    past the last free slot are dropped (slot P)."""
    from coslam_tpu.slam.intercam import _alloc_slots as ja
    from coslam_torch.slam.intercam import _alloc_slots as ta
    P, M = 64, 40
    status = rng.integers(0, 3, P).astype(np.int32)      # ~21 free (0)
    want = rng.random(M) < 0.8
    from coslam_tpu.slam.state import MapPoints as JMap
    from coslam_torch.slam.state import MapPoints as TMap
    jmp = JMap(*(jnp.zeros((P,) + (() if f != "xyz" else (3,)))
                 for f in JMap._fields))._replace(status=jnp.asarray(status))
    tmp = TMap(*(torch.zeros((P,) + (() if f != "xyz" else (3,)))
                 for f in TMap._fields))._replace(status=tp.t(status))
    jslot, jcan = ja(jmp, jnp.asarray(want))
    tslot, tcan = ta(tmp, tp.t(want))
    np.testing.assert_array_equal(tp.n(tslot), np.asarray(jslot))
    np.testing.assert_array_equal(tp.n(tcan), np.asarray(jcan))
    n_free = int((status == 0).sum())
    assert int(np.asarray(jcan).sum()) == min(n_free, int(want.sum()))
    assert want.sum() > n_free                   # some rows were dropped
    got = tp.n(tslot)[tp.n(tcan)]
    np.testing.assert_array_equal(got, np.nonzero(status == 0)[0][:len(got)])


def test_register_map_points(ref, cfgs):
    """From snapshot 12 with a third of the bound features unbound (their
    points unseen by that camera): the same re-acquisitions. The JAX
    package writes every row's value to feature slot clamp(match, 0), so
    a match to feature 0 is lost there (XLA's last write wins); the port
    writes the matches only (ROADMAP.md, queue C). Feature 0 is kept out
    of the candidates."""
    from coslam_tpu.slam.intercam import register_map_points as jreg
    from coslam_torch.slam.intercam import register_map_points as treg
    st, pyr = ref["snaps"][12]
    mpt = st.tracks.mpt.copy()
    mpt[:, 1::3] = -1
    valid = st.tracks.valid.copy()
    valid[:, 0] = False
    st = st._replace(tracks=st.tracks._replace(mpt=mpt, valid=valid))
    jK, _, tK, _ = kmats()
    max_age = cfgs[0].p.num_act_frames
    js_, jn = jreg(jtree(st), jtree(pyr), jK, cfgs[0], max_age=max_age)
    ts_, tn = treg(ttree(st), tp.pyramid_to_torch(pyr), tK, cfgs[1],
                   max_age=max_age)
    assert int(tn) == int(jn) > 20
    np.testing.assert_array_equal(tp.n(ts_.tracks.mpt),
                                  np.asarray(js_.tracks.mpt))


def test_register_map_points_max_age(ref, cfgs):
    """Points last observed more than ``max_age`` frames ago are not
    re-acquired: with half the unbound points aged past a 3-frame limit,
    both packages bind the same fewer features."""
    from coslam_tpu.slam.intercam import register_map_points as jreg
    from coslam_torch.slam.intercam import register_map_points as treg
    st, pyr = ref["snaps"][12]
    mpt = st.tracks.mpt.copy()
    mpt[:, 1::3] = -1
    valid = st.tracks.valid.copy()
    valid[:, 0] = False
    last = st.mappts.last_obs.copy()
    last[::2] -= 5
    st = st._replace(tracks=st.tracks._replace(mpt=mpt, valid=valid),
                     mappts=st.mappts._replace(last_obs=last))
    jK, _, tK, _ = kmats()
    counts = []
    for max_age in (3, cfgs[0].p.num_act_frames):
        js_, jn = jreg(jtree(st), jtree(pyr), jK, cfgs[0], max_age=max_age)
        ts_, tn = treg(ttree(st), tp.pyramid_to_torch(pyr), tK, cfgs[1],
                       max_age=max_age)
        assert int(tn) == int(jn)
        np.testing.assert_array_equal(tp.n(ts_.tracks.mpt),
                                      np.asarray(js_.tracks.mpt))
        counts.append(int(jn))
    assert 0 < counts[0] < counts[1]


def test_joint_pose_update(ref, cfgs):
    """Both cameras' poses perturbed, a few points made dynamic: the joint
    BA lands on the same poses."""
    from coslam_tpu.slam.intercam import joint_pose_update as jj
    from coslam_torch.slam.intercam import joint_pose_update as tj
    from coslam_torch.geometry.se3 import so3_exp_np
    st = ref["snaps"][18][0]
    ptype = st.mappts.ptype.copy()
    alive = np.nonzero(st.mappts.status == 1)[0]
    ptype[alive[::15]] = 1
    R = np.stack([so3_exp_np(np.array([0.004, -0.006, 0.002])) @ r
                  for r in st.R]).astype(np.float32)
    t = (st.t + np.array([[0.02, -0.01, 0.03], [-0.02, 0.01, 0.0]],
                         np.float32))
    st = st._replace(R=R, t=t, mappts=st.mappts._replace(ptype=ptype))
    jK, _, tK, _ = kmats()
    jR, jt = jj(jtree(st), jK, cfgs[0])
    tR, tt = tj(ttree(st), tK, cfgs[1])
    np.testing.assert_allclose(tp.n(tR), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tp.n(tt), np.asarray(jt), atol=1e-3)
    assert np.abs(np.asarray(jt) - t).max() > 5e-3      # it moved


# ------------------------------------------------------ grouping -------

def test_overlap_scan_and_grouping(ref, cfgs):
    from coslam_tpu.slam import grouping as jg
    from coslam_tpu.slam.merge import scan_candidates_device as jscan
    from coslam_torch.slam import grouping as tg
    from coslam_torch.slam.merge import scan_candidates_device as tscan
    st = ref["snaps"][18][0]
    jK, _, tK, _ = kmats()
    jsh, jar = jg.view_overlap_counts(jtree(st))
    tsh, tar = tg.view_overlap_counts(ttree(st))
    np.testing.assert_array_equal(tp.n(tsh), np.asarray(jsh))
    np.testing.assert_allclose(tp.n(tar), np.asarray(jar), rtol=1e-5)
    assert float(np.asarray(jsh)[0, 1]) > 20
    args = (tp.H, tp.W, cfgs[0].p.loop_dormant_age)
    for a, b in zip(tscan(ttree(st), tK, *args),
                    jscan(jtree(st), jK, *args)):
        np.testing.assert_array_equal(tp.n(a), np.asarray(b))
    np.testing.assert_allclose(
        tp.n(tg.host_scan_device(ttree(st), tK, *args)),
        np.asarray(jg.host_scan_device(jtree(st), jK, *args)), rtol=1e-5)
    np.testing.assert_array_equal(tg.camera_grouping(ttree(st), cfgs[1]),
                                  jg.camera_grouping(jtree(st), cfgs[0]))
    # a split: camera 1 loses its shared observations
    mpt = st.tracks.mpt.copy()
    mpt[1] = -1
    split = st._replace(tracks=st.tracks._replace(mpt=mpt))
    gj = jg.camera_grouping(jtree(split), cfgs[0])
    np.testing.assert_array_equal(tg.camera_grouping(ttree(split), cfgs[1]),
                                  gj)
    assert gj.tolist() == [0, 1]
    for gid in ([0, 0, 1, 0], [2, 1, 1, 0, 2], [0, 0]):
        gid = np.asarray(gid, np.int32)
        assert tg.group_camera_tuples(gid) == jg.group_camera_tuples(gid)


# ------------------------------------------------------- map init ------

def test_init_map_multicam(ref, cfgs):
    """Frame 0 of the rig: the same camera order and chained tracks from
    the same matches; poses and point counts agree to the RANSAC bands."""
    from coslam_tpu.slam import initmap as ji
    from coslam_torch.slam import initmap as ti
    st, pyr = ref["snaps"][0]
    pos, valid = st.tracks.pos, st.tracks.valid
    jK, jkc, tK, tkc = kmats()
    want = ji.init_map_multicam(cfgs[0], np.asarray(jK), np.asarray(jkc),
                                jtree(pyr), jnp.asarray(pos), valid)
    got = ti.init_map_multicam(cfgs[1], tK, tkc, tp.pyramid_to_torch(pyr),
                               tp.t(pos), tp.t(valid))
    assert want.ok and got.ok
    assert got.cam_order == want.cam_order

    def errors(res):
        """Rotation error and translation-direction error (degrees) of
        camera 1 relative to camera 0, against the ground truth."""
        R0, t0 = ref["Rs_gt"][0, 0], ref["ts_gt"][0, 0]
        R1, t1 = ref["Rs_gt"][1, 0], ref["ts_gt"][1, 0]
        Rg = R1 @ R0.T
        tg = t1 - Rg @ t0
        Re = res.Rs[1] @ res.Rs[0].T
        te = res.ts[1] - Re @ res.ts[0]
        c = np.clip((np.trace(Re @ Rg.T) - 1) / 2, -1, 1)
        d = np.clip(te @ tg / np.linalg.norm(te) / np.linalg.norm(tg), -1, 1)
        return np.degrees(np.arccos(c)), np.degrees(np.arccos(d))

    (jr, jt), (tr, tt) = errors(want), errors(got)
    print(f"init map: rotation error {tr:.3f} deg (JAX {jr:.3f}), "
          f"translation direction {tt:.3f} deg (JAX {jt:.3f}), points "
          f"{len(got.X)} (JAX {len(want.X)})")
    assert tr < jr + 0.5 and tt < jt + 3.0
    assert abs(len(got.X) - len(want.X)) <= 0.05 * len(want.X)
    assert len(got.X) >= 30          # the init's own commit floor
    # the host chain logic on identical matches
    N = pos.shape[1]
    m = {(0, 1): np.where(np.arange(N) % 3 == 0, (np.arange(N) + 5) % N, -1)}
    for order in ([0, 1], [1, 0]):
        np.testing.assert_array_equal(ti._chain_tracks(order, m, N),
                                      ji._chain_tracks(order, m, N))
    counts = np.array([[0, 5, 9], [5, 0, 2], [9, 2, 0]])
    assert ti._camera_order(counts) == ji._camera_order(counts)


def _matchless_frame(seed: int, C: int = 3):
    """[C, H, W] frames that share no texture: unblurred noise, one
    generator a camera, so that no NCC block pair passes the matcher."""
    return np.concatenate([
        tp.smooth_texture(np.random.default_rng(seed + c), tp.H, tp.W,
                          passes=0) for c in range(C)])


def test_init_map_multicam_without_a_matching_pair():
    """C4: where no camera pair matches, the JAX package's init starts its
    camera path at camera 0 twice and raises KeyError (kept: it is the
    reference); the port's returns a failed init, and its engine retries
    on the next frame until the rig's frames bootstrap it."""
    from coslam_tpu.config import small_test_config as jc
    from coslam_tpu.ops import build_pyramid, detect_corners
    from coslam_tpu.slam import initmap as ji
    from coslam_torch.config import small_test_config as tc
    from coslam_torch.io.synthetic import (make_room, render_sequence,
                                           rig_sequence)
    from coslam_torch.slam import initmap as ti
    from coslam_torch.slam.pipeline import CoSlamEngine
    C = 3
    cfg = jc(C, tp.H, tp.W)
    pyr = build_pyramid(jnp.asarray(_matchless_frame(100)), cfg.klt.n_levels)
    det = detect_corners(pyr.imgs[0], pyr.dxs[0], pyr.dys[0], cfg.klt,
                         cfg.cap.max_features)
    pos, valid = np.asarray(det.pos), np.asarray(det.valid)
    assert (valid.sum(1) > 50).all()
    K, kc = tp.kmats(C)
    with pytest.raises(KeyError):
        ji.init_map_multicam(cfg, K, kc, pyr, jnp.asarray(pos),
                             jnp.asarray(valid))
    got = ti.init_map_multicam(tc(C, tp.H, tp.W), tp.t(K), tp.t(kc),
                               tp.pyramid_to_torch(tp.to_numpy(pyr)),
                               tp.t(pos), tp.t(valid))
    assert not got.ok

    n_rig = 3
    planes = make_room(np.random.default_rng(0), size=10.0)
    Rs, ts = rig_sequence(C, n_rig, baseline=1.0, forward=0.06)
    rig = torch.stack([render_sequence(planes, tp.KMAT[0], Rs[c], ts[c],
                                       tp.H, tp.W, device="cpu")
                       for c in range(C)], 1)
    frames = [_matchless_frame(10), _matchless_frame(20)] + list(rig)
    eng = CoSlamEngine(tc(C, tp.H, tp.W), K, kc, device="cpu")
    boots = []
    for f, img in enumerate(frames):
        boots.append(bool(eng.process_frame(img).get("bootstrap")))
        assert eng.bootstrapped == any(boots)
    assert boots[:2] == [False, False]
    assert any(boots[2:])


# ---------------------------------------------------- fused step -------

def test_frame_step_two_cameras(ref, cfgs):
    """Three fused steps (frames 13-15) from snapshot 12, each package
    building its own pyramids from the same images: classification and
    dynamic voting run inside."""
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
        img = ref["frames"][f]
        js_, jp, jfs = jstep(js_, jp, jnp.asarray(img), jK, jkc, cfgs[0])
        ts_, tpyr, tfs = tstep(ts_, tpyr, tp.t(img), tK, tkc, cfgs[1])
        jv, tv = np.asarray(jpack(jfs)), tp.n(pack_stats(tfs))
        assert jv.shape == tv.shape
        ju, tu = unpack_stats(jv, C, D), unpack_stats(tv, C, D)
        for k in ("n_tracked", "n_inliers", "n_mapped"):
            assert (np.abs(getattr(tu, k) - getattr(ju, k)) <= 3).all(), k
        assert abs(tu.n_static - ju.n_static) <= 3
        assert tu.n_dynamic == ju.n_dynamic
        np.testing.assert_allclose(tu.R, ju.R, atol=2e-3)
        np.testing.assert_allclose(tu.t, ju.t, atol=5e-3)
    assert ju.n_static > 100
    assert int(ts_.frame) == int(js_.frame) == 15
    tp.assert_tracks_close(js_.tracks, ts_.tracks, max_flips=8, pos_tol=1e-2,
                           max_mpt_diff=4)


# ------------------------------------------------- engine decisions ----

def test_grouping_hysteresis_and_merge_check():
    """The engines' host-side group decisions on the same device scans: a
    split is committed only when two consecutive grouping rounds propose
    it, a join at once; the merge prefilter reads the candidate counts
    the same way."""
    from coslam_tpu.config import small_test_config as jc
    from coslam_tpu.slam.pipeline import CoSlamEngine as JEngine
    from coslam_torch.config import small_test_config as tc
    from coslam_torch.slam.pipeline import CoSlamEngine as TEngine
    K, kc = tp.kmats(3)
    je, te = JEngine(jc(3, tp.H, tp.W), K, kc), \
        TEngine(tc(3, tp.H, tp.W), K, kc, device="cpu")
    img = float(tp.H * tp.W)
    joined = np.full((3, 3), 100.0), np.full((3, 3), 0.5 * img)
    apart = np.array([[100, 100, 0], [100, 100, 0], [0, 0, 100]], float), \
        joined[1]
    mc = np.array([[0, 10, 60], [0, 0, 5], [3, 0, 0]], float)
    own = np.array([200.0, 150.0, 80.0])
    history = []
    for shared, area in (joined, apart, joined, apart, apart, joined):
        scan = (shared, area, mc, own, np.zeros(3))
        for e in (je, te):
            e._host_scan = lambda scan=scan: scan
            e._update_grouping()
        np.testing.assert_array_equal(te.group_id, je.group_id)
        history.append(te.group_id.tolist())
        assert te._merge_possible() == je._merge_possible()
    assert history == [[0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0],
                       [0, 0, 1], [0, 0, 0]]
    np.testing.assert_array_equal(tp.n(te.state.group_id), je.group_id)
    te.group_id = je.group_id = np.array([0, 0, 1], np.int32)
    assert te._merge_possible() and je._merge_possible()
