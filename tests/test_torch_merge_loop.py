"""Module parity of the merge and loop-closure slice: ``coslam_torch``
against ``coslam_tpu`` on the CPU, on seeded numpy inputs and on states
of the JAX engine's 20-frame two-camera rig (tests/test_pipeline_multicam.py's
scene; snapshots after frames 12 and 18).

Tolerances, and why:
- host numpy helpers (hull, group pairs, consensus scale) and integer
  decisions on identical inputs (candidate lists, registrations, fusion
  status, BA tables) are exact;
- ``pnp_dlt`` on clean data to 1e-4 (a float32 12x12 eigh);
- ``ransac_pnp`` and the merge bridge draw from ``jax.random`` in the
  JAX package and from a seeded ``torch.Generator`` in the port:
  compared by consensus size (within 2; the bridge within 3) and pose
  (1e-3), not sample for sample;
- ``ncc_search`` at G = 43: the same best pixel on >= 99% of the centres
  (the window variance cancels in float32, so a near tie can flip),
  scores to 1e-4;
- ``apply_group_transform`` to 1e-5 of each quantity's scale (float32
  se(3) exp/log and products);
- ``close_loop``: the same outcome, consensus within 2, poses to 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_parity as tp

C = 2
F = 20
SNAPS = (12, 18)


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


def with_params(cfg, **kw):
    return cfg.replace(p=dataclasses.replace(cfg.p, **kw))


def leaf(tree, path):
    for name in path.split("."):
        tree = getattr(tree, name)
    return tree


def assert_states_close(js_, ts_, fields, rtol=1e-5):
    """Float leaves of two states within ``rtol`` of each leaf's scale."""
    for f in fields:
        a = np.asarray(leaf(js_, f))
        b = tp.n(leaf(ts_, f))
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, atol=rtol * scale, err_msg=f)


# ---------------------------------------------------------- host helpers --

def test_hull_helpers(rng):
    from coslam_tpu.geometry import hull as jh
    from coslam_torch.geometry import hull as th
    for n in (1, 2, 3, 40, 300):
        pts = rng.uniform(0, 200, (n, 2))
        if n == 40:
            pts[:10] = pts[0]                     # repeated points
        jhull, thull = jh.convex_hull(pts), th.convex_hull(pts)
        np.testing.assert_array_equal(thull, jhull)
        assert th.polygon_area(thull) == jh.polygon_area(jhull)
        q = rng.uniform(-20, 220, (500, 2))
        q[:len(jhull)] = jhull                    # on the hull: inside
        np.testing.assert_array_equal(th.points_in_hull(q, thull),
                                      jh.points_in_hull(q, jhull))
    line = np.stack([np.arange(6.0), 2 * np.arange(6.0)], -1)
    np.testing.assert_array_equal(th.convex_hull(line), jh.convex_hull(line))
    assert th.polygon_area(th.convex_hull(line)) == 0.0


def test_group_adjacent_pairs_and_ncc_pairwise(rng):
    from coslam_tpu.slam.grouping import group_adjacent_pairs as jp
    from coslam_torch.slam.grouping import group_adjacent_pairs as tpairs
    from coslam_tpu.ops.ncc import ncc_pairwise as jn
    from coslam_torch.ops.ncc import ncc_pairwise as tn
    for gid in ([0, 0, 1, 0], [2, 1, 1, 0, 2], [0], [0, 1, 2]):
        gid = np.asarray(gid, np.int32)
        assert tpairs(gid) == jp(gid)
    # quarter-integer entries: every product and partial sum is exact in
    # float32, so the order of the 121-term sums cannot show
    a = (rng.integers(-8, 9, (30, 121)) / 4).astype(np.float32)
    b = (rng.integers(-8, 9, (30, 121)) / 4).astype(np.float32)
    np.testing.assert_array_equal(tp.n(tn(tp.t(a), tp.t(b))),
                                  np.asarray(jn(jnp.asarray(a),
                                                jnp.asarray(b))))


@pytest.mark.parametrize("kind", ["tight", "spread", "few"])
def test_consensus_log_scale(rng, kind):
    from coslam_tpu.slam.merge import consensus_log_scale as jc
    from coslam_torch.slam.merge import consensus_log_scale as tc
    if kind == "tight":
        r = np.exp(rng.normal(np.log(1.3), 0.05, 40))
        r[:12] = rng.uniform(0.2, 5.0, 12)        # a mismatched minority
        r[3] = np.nan
    elif kind == "spread":
        r = np.exp(rng.uniform(-2, 2, 40))
    else:
        r = np.array([1.0, 1.1, 0.9, -1.0, np.inf])
    want, got = jc(r, min_members=8, max_width=0.4), \
        tc(r, min_members=8, max_width=0.4)
    assert got == want
    assert (want is None) == (kind != "tight")


# ------------------------------------------------------------------ PnP --

def _pnp_scene(rng, n, centroid=(0.0, 0.0, 8.0)):
    """Points around ``centroid``, seen by a camera 6 units in front of
    them (tests/test_pnp.py's scenes)."""
    from coslam_torch.geometry.se3 import so3_exp_np
    R = so3_exp_np(np.array([0.1, -0.2, 0.05]))
    X = (rng.uniform(-3, 3, (n, 3)) + centroid).astype(np.float32)
    c_cam = np.asarray(centroid, np.float32) + np.array([0.5, 0.2, -6.0])
    t = (-R @ c_cam).astype(np.float32)
    Xc = X @ R.T + t
    xn = (Xc[:, :2] / Xc[:, 2:]).astype(np.float32)
    return X, xn, R, t


def test_pnp_dlt_clean(rng):
    from coslam_tpu.geometry.pnp import pnp_dlt as jd
    from coslam_torch.geometry.pnp import pnp_dlt as td
    for off in ((0, 0, 8.0), (40.0, -25.0, 60.0)):    # off-origin scene
        X, xn, R, t = _pnp_scene(rng, 60, off)
        w = rng.uniform(0.5, 1.0, 60).astype(np.float32)
        Rj, tj = jd(jnp.asarray(X), jnp.asarray(xn), jnp.asarray(w))
        Rt, tt = td(tp.t(X), tp.t(xn), tp.t(w))
        np.testing.assert_allclose(tp.n(Rt), np.asarray(Rj), atol=1e-4)
        np.testing.assert_allclose(tp.n(tt), np.asarray(tj),
                                   atol=1e-4 * max(1.0, np.abs(tj).max()))
        np.testing.assert_allclose(tp.n(Rt), R, atol=1e-3)


@pytest.mark.parametrize("mode", ["uniform", "prosac", "prosac_R0"])
def test_ransac_pnp_outliers(rng, mode):
    """Half the correspondences are outliers (and a tail is masked off):
    consensus within 2 and the pose within 1e-3 of the JAX package's."""
    from coslam_tpu.geometry.pnp import ransac_pnp as jr
    from coslam_torch.geometry.pnp import ransac_pnp as tr
    n = 200
    X, xn, R, t = _pnp_scene(rng, n)
    xn = xn + rng.normal(0, 0.2 / 180, xn.shape).astype(np.float32)
    bad = rng.random(n) < 0.5
    xn[bad] = rng.uniform(-0.6, 0.6, (bad.sum(), 2)).astype(np.float32)
    mask = np.arange(n) < 180
    score = np.where(bad, rng.uniform(0.3, 0.8, n),
                     rng.uniform(0.6, 1.0, n)).astype(np.float32)
    # uniform draws: 2048 hypotheses hold ~30 all-inlier samples
    kw = dict(num_hypotheses=2048 if mode == "uniform" else 512,
              thresh=3.0 / 180)
    if mode != "uniform":
        kw["score"] = score
    if mode == "prosac_R0":
        kw["R0"], kw["t0"] = R, t
    want = jr(jax.random.PRNGKey(3), jnp.asarray(X), jnp.asarray(xn),
              jnp.asarray(mask), **{k: jnp.asarray(v) if k in
                                    ("score", "R0", "t0") else v
                                    for k, v in kw.items()})
    got = tr(torch.Generator().manual_seed(3), tp.t(X), tp.t(xn),
             tp.t(mask), **{k: tp.t(v) if k in ("score", "R0", "t0") else v
                            for k, v in kw.items()})
    nj, nt = int(want.num_inliers), int(got.num_inliers)
    assert abs(nt - nj) <= 2 and nj >= 0.8 * (~bad & mask).sum(), (nt, nj)
    assert not (tp.n(got.inliers) & ~mask).any()
    np.testing.assert_allclose(tp.n(got.R), np.asarray(want.R), atol=1e-3)
    np.testing.assert_allclose(tp.n(got.t), np.asarray(want.t), atol=1e-3)


# ------------------------------------------------------------------ NCC --

def test_ncc_search_loop_shape(rng):
    """The loop closure's search (radius 16: G = 43, N = 256): templates
    cut at displaced true positions, some centres near the border (their
    window clamps and they score NCC_INVALID)."""
    from coslam_tpu.ops import ncc as jn
    from coslam_torch.ops import ncc as tn
    img = tp.smooth_texture(rng, 150, 200, passes=1)[0]
    N, r, sr = 256, 5, 16
    true = rng.uniform(25, [175, 125], (N, 2)).astype(np.float32)
    true = np.round(true)
    centers = (true + rng.integers(-12, 13, (N, 2))).astype(np.float32)
    centers[:6] = [[3, 40], [190, 70], [60, 2], [100, 147], [21, 21],
                   [178, 128]]
    blocks, _ = jn.extract_ncc_blocks(jnp.asarray(img), jnp.asarray(true), r)
    tmpl = np.asarray(blocks)
    tmpl = tmpl + rng.normal(0, 0.01, tmpl.shape).astype(np.float32)
    tmpl -= tmpl.mean(1, keepdims=True)
    tmpl /= np.linalg.norm(tmpl, axis=1, keepdims=True)
    jpx, jsc = jn.ncc_search(jnp.asarray(img), jnp.asarray(centers),
                             jnp.asarray(tmpl), search_radius=sr,
                             patch_radius=r)
    tpx, tsc = tn.ncc_search(tp.t(img), tp.t(centers), tp.t(tmpl),
                             search_radius=sr, patch_radius=r)
    jpx, jsc, tpx, tsc = (np.asarray(jpx), np.asarray(jsc), tp.n(tpx),
                          tp.n(tsc))
    same = (tpx == jpx).all(1)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(tsc[same], jsc[same], atol=1e-4)
    invalid = jsc == jn.NCC_INVALID
    np.testing.assert_array_equal(tsc == tn.NCC_INVALID, invalid)
    base = np.round(centers).astype(int) - (r + sr)
    clamped = (base < 0).any(1) | (base[:, 0] > 200 - 43 - 1) \
        | (base[:, 1] > 150 - 43 - 1)
    np.testing.assert_array_equal(invalid, clamped)
    assert clamped[:4].all() and not clamped[4]
    found = ~invalid & (np.abs(jpx - true).max(1) == 0)
    assert found.sum() > 0.9 * (~invalid).sum()


# ------------------------------------------------------ registration ----

@pytest.mark.parametrize("opt", ["gate_scale", "min_age", "min_score",
                                 "steal_young", "no_max_age"])
def test_register_map_points_options(ref, cfgs, opt):
    """From snapshot 12 with a third of the bound features unbound, half
    the points aged, and 20 of camera 0's bound points revisited: each
    gets a dormant twin (a copy in a free slot, last seen 8 frames ago)
    and is itself made young, as a revisit re-maps a dormant structure.
    Each option of the merge and loop call sites gives the same mpt
    table. Feature 0 is kept out of the candidates (the reference's
    scatter can lose a match there; the port writes matches only)."""
    from coslam_tpu.slam.intercam import register_map_points as jreg
    from coslam_torch.slam.intercam import register_map_points as treg
    st, pyr = ref["snaps"][12]
    frame = int(st.frame)
    mpt = st.tracks.mpt.copy()
    valid = st.tracks.valid.copy()
    valid[:, 0] = False
    mp = st.mappts
    fields = {f: getattr(mp, f).copy() for f in mp._fields}
    fields["last_obs"][::2] -= 8
    src = mpt[0][(mpt[0] >= 0) & valid[0]][:20]
    twin = np.nonzero(mp.status == 0)[0][:20]
    for f in fields:
        fields[f][twin] = fields[f][src]
    fields["last_obs"][twin] = frame - 8
    fields["first_frame"][src] = frame
    mpt[:, 1::3] = -1
    st = st._replace(tracks=st.tracks._replace(mpt=mpt, valid=valid),
                     mappts=mp._replace(**fields))
    kw = {"gate_scale": dict(max_age=50, gate_scale=3.0),
          "min_age": dict(min_age=6),
          "min_score": dict(max_age=50, min_score=0.5),
          "steal_young": dict(min_age=6, min_score=0.5, steal_young=True),
          "no_max_age": dict()}[opt]
    jK, _, tK, _ = kmats()
    js_, jn = jreg(jtree(st), jtree(pyr), jK, cfgs[0], **kw)
    ts_, tn = treg(ttree(st), tp.pyramid_to_torch(pyr), tK, cfgs[1], **kw)
    assert int(tn) == int(jn) > 0
    np.testing.assert_array_equal(tp.n(ts_.tracks.mpt),
                                  np.asarray(js_.tracks.mpt))
    if opt == "steal_young":
        # features bound to the young points were won back by their twins
        assert np.isin(np.asarray(js_.tracks.mpt)[0], twin).sum() >= 5


# ------------------------------------------------------------------ BA --

def test_build_ba_table_window(ref, cfgs):
    """The merge-time joint BA table (16 keyframes over a partly filled
    ring): equal tables; the mid-window keyframes are free."""
    from coslam_tpu.slam import steps as js
    from coslam_torch.slam import steps as ts_
    st = ref["snaps"][18][0]
    jK, _, tK, _ = kmats()
    jprob, jring, jok = js.build_ba_table(jtree(st), jK, cfgs[0], window=16)
    tprob, tring, tok = ts_.build_ba_table(ttree(st), tK, cfgs[1], window=16)
    for f in jprob._fields:
        np.testing.assert_array_equal(tp.n(getattr(tprob, f)),
                                      np.asarray(getattr(jprob, f)), f)
    np.testing.assert_array_equal(tp.n(tring), np.asarray(jring))
    np.testing.assert_array_equal(tp.n(tok), np.asarray(jok))
    fixed = np.asarray(jprob.cam_fixed).reshape(16, C)
    n_kf = int(np.asarray(jok).sum())
    assert 2 < n_kf < 16 and not fixed[2:n_kf].any() and fixed[:2].all()


# ---------------------------------------------------- group transform ---

@pytest.mark.parametrize("kind", ["rigid", "graded", "scaled", "anchor"])
def test_apply_group_transform(ref, cfgs, kind):
    from coslam_tpu.slam.merge import apply_group_transform as ja
    from coslam_torch.slam.merge import apply_group_transform as ta
    from coslam_torch.geometry.se3 import so3_exp_np
    st = ref["snaps"][18][0]
    R_s = so3_exp_np(np.array([0.02, -0.05, 0.01]))
    t_s = np.array([0.1, -0.05, 0.2], np.float32)
    move = np.array([False, True])
    gid = np.array([0, 1], np.int32)
    kw = {"rigid": dict(),
          "graded": dict(f_sep=6),
          "scaled": dict(f_sep=6, scale=1.3),
          "anchor": dict(f_sep=6, anchor_before=15, scale=0.8)}[kind]
    if kind == "anchor":
        move = np.array([True, True])
        gid = np.array([0, 0], np.int32)
    js_ = ja(jtree(st), cfgs[0], move, R_s, t_s, gid, **kw)
    ts_ = ta(ttree(st), cfgs[1], move, R_s, t_s, gid, **kw)
    assert_states_close(js_, ts_, (
        "R", "t", "pose_hist_R", "pose_hist_t", "pose_hist_long_R",
        "pose_hist_long_t", "kfs.R", "kfs.t", "mappts.xyz", "mappts.cov"))
    moved = np.abs(np.asarray(js_.mappts.xyz) - st.mappts.xyz).max(1) > 0
    assert moved.any() and (kind != "anchor" or not moved.all())
    np.testing.assert_array_equal(np.asarray(js_.R)[~move], st.R[~move])


def test_fuse_duplicate_points(ref, cfgs):
    """Camera 1's points near camera 0's go false after a split (planted
    duplicates: a few camera-1 points moved onto camera-0 points)."""
    from coslam_tpu.slam.merge import MergeCandidate as JC
    from coslam_tpu.slam.merge import fuse_duplicate_points as jf
    from coslam_torch.slam.merge import MergeCandidate as TC
    from coslam_torch.slam.merge import fuse_duplicate_points as tf
    st = ref["snaps"][18][0]
    mp = st.mappts
    alive = (mp.status == 1) & (mp.ptype == 0)
    own0 = np.nonzero(alive & (mp.owner == 0))[0]
    own1 = np.nonzero(alive & (mp.owner == 1))[0]
    xyz = mp.xyz.copy()
    xyz[own1[:15]] = xyz[own0[:15]] + 0.01
    xyz[own1[15:30]] += 1.0
    st = st._replace(mappts=mp._replace(xyz=xyz))
    gid = np.array([0, 1], np.int32)
    want = np.asarray(jf(jtree(st), cfgs[0], gid, JC(0, 1, 60)).mappts.status)
    got = tp.n(tf(ttree(st), cfgs[1], gid, TC(0, 1, 60)).mappts.status)
    np.testing.assert_array_equal(got, want)
    assert (want[own1[:15]] == 2).all() and (want != mp.status).sum() >= 15


# -------------------------------------------------------- candidates ----

def test_merge_candidates(ref, cfgs):
    """The rig's two cameras as two groups: the same candidate list (both
    directions); with the distance gate tightened, none."""
    from coslam_tpu.slam.merge import merge_candidates as jm
    from coslam_torch.slam.merge import merge_candidates as tm
    st = ref["snaps"][18][0]
    K, _ = tp.kmats(C)
    gid = np.array([0, 1], np.int32)
    want = jm(jtree(st), cfgs[0], K, gid)
    got = tm(ttree(st), cfgs[1], K, gid)
    assert [tuple(c) for c in got] == [tuple(c) for c in want]
    assert len(want) >= 1
    tight = [with_params(c, max_dist_ratio=0.01) for c in cfgs]
    assert tm(ttree(st), tight[1], K, gid) == jm(jtree(st), tight[0], K,
                                                 gid) == []


def _dormant(st, age, every=2):
    """Every ``every``-th alive point last observed ``age`` frames ago."""
    last = st.mappts.last_obs.copy()
    alive = np.nonzero(st.mappts.status == 1)[0]
    last[alive[::every]] = int(st.frame) - age
    return st._replace(mappts=st.mappts._replace(last_obs=last))


def test_find_loop_candidates(ref, cfgs):
    from coslam_tpu.slam.loop import find_loop_candidates as jf
    from coslam_torch.slam.loop import find_loop_candidates as tf
    st = _dormant(ref["snaps"][18][0], 40)
    K, _ = tp.kmats(C)
    for over in (12, 10 ** 4):
        jc, tc = (with_params(c, loop_dormant_age=30, loop_overlap_min=over)
                  for c in cfgs)
        want, got = jf(jtree(st), jc, K), tf(ttree(st), tc, K)
        assert got == want
        assert (len(want) == 2) == (over == 12)


# ------------------------------------------------------ merge bridge ----

def _drifted(st, yaw=0.08, shift=(0.15, 0.0, 0.05)):
    """Snapshot with the groups split and camera 1 (its pose, pose rings
    and owned points) moved by a rigid world transform: a drifted moving
    group."""
    from coslam_torch.geometry.se3 import so3_exp_np
    if yaw == 0.0:
        return st._replace(group_id=np.array([0, 1], np.int32))
    Rd = so3_exp_np(np.array([0.0, yaw, 0.0]))
    td = np.asarray(shift, np.float32)
    # world x -> Rd x + td; camera poses T' = T o D^-1
    R = st.R.copy()
    t = st.t.copy()
    R[1] = st.R[1] @ Rd.T
    t[1] = st.t[1] - R[1] @ td
    ph_R, ph_t = st.pose_hist_R.copy(), st.pose_hist_t.copy()
    ph_R[1] = st.pose_hist_R[1] @ Rd.T
    ph_t[1] = st.pose_hist_t[1] - np.einsum("tij,j->ti", ph_R[1], td)
    mp = st.mappts
    xyz = mp.xyz.copy()
    own1 = mp.owner == 1
    xyz[own1] = xyz[own1] @ Rd.T + td
    return st._replace(R=R, t=t, pose_hist_R=ph_R, pose_hist_t=ph_t,
                       mappts=mp._replace(xyz=xyz),
                       group_id=np.array([0, 1], np.int32))


@pytest.mark.parametrize("drift", ["drifted", "noop"])
def test_merge_groups_bridge(ref, cfgs, drift):
    """The bridge from camera 0's map to camera 1 on snapshot 18: drifted,
    both realign (not a no-op) to the same camera-1 pose; undrifted, both
    find the identity explains it (no-op)."""
    from coslam_tpu.slam.merge import MergeCandidate as JC
    from coslam_tpu.slam.merge import merge_groups as jm
    from coslam_torch.slam.merge import MergeCandidate as TC
    from coslam_torch.slam.merge import merge_groups as tm
    st, pyr = ref["snaps"][18]
    st = _drifted(st, yaw=0.08 if drift == "drifted" else 0.0)
    jK, jkc, tK, tkc = kmats()
    gid = np.array([0, 1], np.int32)
    want = jm(jtree(st), cfgs[0], jtree(pyr), jK, jkc, gid, JC(0, 1, 60),
              f_sep=8)
    got = tm(ttree(st), cfgs[1], tp.pyramid_to_torch(pyr), tK, tkc, gid,
             TC(0, 1, 60), f_sep=8)
    print(f"bridge {drift}: JAX ok={want.ok} noop={want.noop} "
          f"n={want.n_matches}; port ok={got.ok} noop={got.noop} "
          f"n={got.n_matches}")
    assert got.ok == want.ok is True
    assert got.noop == want.noop == (drift == "noop")
    assert abs(got.n_matches - want.n_matches) <= 3
    assert want.n_matches >= 10
    np.testing.assert_allclose(tp.n(got.state.R), np.asarray(want.state.R),
                               atol=1e-3)
    np.testing.assert_allclose(tp.n(got.state.t), np.asarray(want.state.t),
                               atol=1e-3)
    assert got.scale_move == pytest.approx(want.scale_move, abs=1e-3)
    if drift == "drifted":
        # the realignment undid most of the drift
        err = np.abs(tp.n(got.state.R)[1] - ref["snaps"][18][0].R[1]).max()
        assert err < 0.02


# ------------------------------------------------------- loop closure ---

def _loop_state(st):
    """Snapshot 18 with half the points dormant (unseen for 40 frames) and
    camera 0's pose glitched by 0.6 degrees: the closure re-acquires the
    dormant points and corrects the glitch."""
    from coslam_torch.geometry.se3 import so3_exp_np
    st = _dormant(st, 40)
    R = st.R.copy()
    R[0] = so3_exp_np(np.array([0.0, 0.01, 0.0])) @ st.R[0]
    return st._replace(R=R)


def test_close_loop(ref, cfgs):
    from coslam_tpu.slam.loop import close_loop as jl
    from coslam_torch.slam.loop import close_loop as tl
    st, pyr = ref["snaps"][18]
    st0 = st
    st = _loop_state(st)
    jc, tc = (with_params(c, loop_dormant_age=30, loop_min_inliers=7)
              for c in cfgs)
    jK, jkc, tK, tkc = kmats()
    gid = np.array([0, 0], np.int32)
    want = jl(jtree(st), jc, jtree(pyr), jK, jkc, gid, 0)
    got = tl(ttree(st), tc, tp.pyramid_to_torch(pyr), tK, tkc, gid, 0)
    print(f"close_loop: JAX ok={want.ok} n={want.n_inliers} "
          f"f_anchor={want.f_anchor} scale={want.scale}; port ok={got.ok} "
          f"n={got.n_inliers} f_anchor={got.f_anchor} scale={got.scale}")
    assert got.ok == want.ok is True
    assert abs(got.n_inliers - want.n_inliers) <= 2
    assert got.f_anchor == want.f_anchor and got.cam == want.cam == 0
    assert got.scale == pytest.approx(want.scale, abs=1e-3)
    np.testing.assert_allclose(tp.n(got.state.R), np.asarray(want.state.R),
                               atol=1e-3)
    np.testing.assert_allclose(tp.n(got.state.t), np.asarray(want.state.t),
                               atol=1e-3)
    # most of the glitch is corrected
    glitch = np.abs(st.R[0] - st0.R[0]).max()
    assert np.abs(tp.n(got.state.R)[0] - st0.R[0]).max() < 0.6 * glitch
    # re-acquired dormant points bound to live features: the same count
    jm, tm = np.asarray(want.state.tracks.mpt), tp.n(got.state.tracks.mpt)
    assert abs(int((tm != st.tracks.mpt).sum())
               - int((jm != st.tracks.mpt).sum())) <= 3


# ------------------------------------------------- engine commit sites --

def test_large_err_armed_at_both_commit_sites(monkeypatch):
    """A committed realigning merge and a committed loop closure each open
    the 12-frame widened-gate window, and the fused step sees it."""
    from coslam_torch.config import small_test_config
    from coslam_torch.slam import pipeline as pl
    from coslam_torch.slam.loop import LoopResult
    from coslam_torch.slam.merge import MergeCandidate, MergeResult
    K, kc = tp.kmats(2)
    eng = pl.CoSlamEngine(small_test_config(2, tp.H, tp.W), K, kc,
                          device="cpu")
    monkeypatch.setattr(pl, "merge_candidates",
                        lambda *a: [MergeCandidate(0, 1, 80)])
    monkeypatch.setattr(pl, "merge_groups", lambda st, *a, **k:
                        MergeResult(True, st, 1.0, 30, scale_move=1.1))
    monkeypatch.setattr(pl, "fuse_duplicate_points", lambda st, *a: st)
    monkeypatch.setattr(pl, "register_map_points",
                        lambda st, *a, **k: (st, 0))
    monkeypatch.setattr(pl, "find_loop_candidates", lambda *a: [(0, 40)])
    monkeypatch.setattr(pl, "close_loop", lambda st, *a, **k:
                        LoopResult(True, st, 0, 20, 3, 1.0))
    bas = []
    monkeypatch.setattr(eng, "_keyframe_ba", lambda w: bas.append(w))
    eng.group_id = np.array([0, 1], np.int32)
    eng.group_hist = [(0, 0)] * 10 + [(0, 1)] * 30
    eng.frame = 40
    eng._try_merge(None)
    assert eng._large_err_until == 52
    assert eng.merge_log[-1]["frame"] == 40 and "noop" not in \
        eng.merge_log[-1]
    assert eng.group_id.tolist() == [0, 0] and bas == [16]
    # a no-op merge does not open the window
    monkeypatch.setattr(pl, "merge_groups", lambda st, *a, **k:
                        MergeResult(True, st, 1.0, 30, noop=True))
    eng.group_id = np.array([0, 1], np.int32)
    eng.frame = 45
    eng._try_merge(None)
    assert eng._large_err_until == 52 and eng.merge_log[-1]["noop"]
    # the loop closure, past the merge's settle window
    eng._host_scan = lambda: (None, None, None, None, np.array([50, 0]))
    eng.frame = 200
    eng._try_loop_closure(None)
    assert eng._large_err_until == 212 and eng.loop_log[-1]["frame"] == 200
    # the fused step sees the window
    seen = []

    def fake_step(*a, mesh=None, large_err=False):
        assert mesh is None
        seen.append(large_err)
        raise StopIteration

    monkeypatch.setattr(pl, "frame_step", fake_step)
    eng.bootstrapped = True
    for f in (211, 212):
        eng.frame = f
        with pytest.raises(StopIteration):
            eng.process_frame(np.zeros((2, tp.H, tp.W), np.float32))
    assert seen == [True, False]
