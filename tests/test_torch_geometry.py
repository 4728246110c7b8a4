"""Geometry parity: ``coslam_torch.geometry`` against ``coslam_tpu.geometry``
on the same numpy inputs (se3, robust, camera, triangulate, epipolar,
fivepoint).

Tolerances: both sides compute in float32 with the same formulas, but
XLA and PyTorch order and fuse float operations differently, so values
agree to a few float32 ulps of their magnitude: 1e-5 relative (1e-6
absolute) for direct formulas, 1e-4 through a 3x3 solve or a singular
decomposition, 1e-3 through the 4x4 DLT eigenproblem or the midpoint
denominator. The RANSAC samplers draw from different generators, so
RANSAC is held to its consensus set and pose error."""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_parity as tp

RT5, AT6 = 1e-5, 1e-6
# the homogeneous DLT takes the smallest eigenvector of the 4x4 normal
# matrix, whose condition number is the square of the design matrix's:
# float32 eigensolvers of two libraries agree to ~1e-3 relative in X
EIGH_RT = 1e-3


def mods(name):
    return (importlib.import_module(f"coslam_tpu.geometry.{name}"),
            importlib.import_module(f"coslam_torch.geometry.{name}"))


def both(name, fn, *args, **kw):
    """Run ``fn`` of geometry module ``name`` in both packages on the
    numpy ``args``; returns (jax outputs, port outputs) as numpy."""
    jm, tm = mods(name)
    j = getattr(jm, fn)(*[jnp.asarray(a) for a in args], **kw)
    t = getattr(tm, fn)(*[tp.t(a) for a in args], **kw)
    return (jax.tree.map(np.asarray, j),
            jax.tree.map(tp.n, t, is_leaf=torch.is_tensor))


def close(a, b, rtol=RT5, atol=AT6):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), rtol=rtol,
                                   atol=atol)


def rand_rot(rng, n, scale=1.0):
    w = (scale * rng.standard_normal((n, 3))).astype(np.float32)
    return np.asarray(jax.vmap(mods("se3")[0].so3_exp)(jnp.asarray(w)))


def scene(rng, n=64, views=3):
    """Points in front of ``views`` cameras looking down +z."""
    X = rng.uniform([-2, -2, 4], [2, 2, 8], (n, 3)).astype(np.float32)
    R = rand_rot(rng, views, 0.05)
    t = (0.3 * rng.standard_normal((views, 3))).astype(np.float32)
    return X, R, t


# ---------------------------------------------------------------- se3 ----

def test_so3_exp_log_hat(rng):
    # angles from near zero (the series branches) up to near pi
    w = (rng.standard_normal((32, 3)) * rng.choice(
        [1e-9, 1e-4, 0.5, 1.5, 1.8], (32, 1))).astype(np.float32)
    close(*both("se3", "so3_hat", w))
    close(*both("se3", "so3_exp", w), rtol=1e-4, atol=1e-6)
    R = rand_rot(rng, 32, 1.0)
    close(*both("se3", "so3_log", R), rtol=1e-4, atol=1e-5)


def test_se3_exp_log(rng):
    xi = (rng.standard_normal((16, 6)) * 0.7).astype(np.float32)
    close(*both("se3", "se3_exp", xi), rtol=1e-4, atol=1e-5)
    R = rand_rot(rng, 16, 0.8)
    t = rng.standard_normal((16, 3)).astype(np.float32)
    close(*both("se3", "se3_log", R, t), rtol=1e-4, atol=1e-5)


def test_so3_projections(rng):
    M = (rand_rot(rng, 8) + 0.05 * rng.standard_normal((8, 3, 3))
         ).astype(np.float32)
    close(*both("se3", "project_to_so3", M), rtol=1e-4, atol=1e-5)
    close(*both("se3", "orthonormalize_fast", M), rtol=1e-4, atol=1e-5)


def test_compose_invert_relative(rng):
    Ra, Rb = rand_rot(rng, 5), rand_rot(rng, 5)
    ta, tb = (rng.standard_normal((2, 5, 3))).astype(np.float32)
    close(*both("se3", "compose", Ra, ta, Rb, tb))
    close(*both("se3", "invert", Ra, ta))
    close(*both("se3", "relative_pose", Ra, ta, Rb, tb), atol=1e-5)


# ------------------------------------------------------------- robust ----

@pytest.mark.parametrize("fn,param", [("tukey_weight", 4.685),
                                      ("huber_weight", 1.345)])
def test_robust_weights(rng, fn, param):
    r = (rng.standard_normal(200) * 5).astype(np.float32)
    close(*both("robust", fn, r, param))


# ------------------------------------------------------------- camera ----

KC = np.array([-0.25, 0.08, 1e-3, -5e-4, 0.01], np.float32)
KM = np.array([[180.0, 0, 100], [0, 181.0, 75], [0, 0, 1]], np.float32)


def test_distortion_round_trip(rng):
    xn = rng.uniform(-0.6, 0.6, (100, 2)).astype(np.float32)
    close(*both("camera", "distort_normalized", xn, KC))
    xd = np.asarray(mods("camera")[0].distort_normalized(xn, KC))
    # the fixed 8-iteration inverse, as the reference runs it
    close(*both("camera", "undistort_normalized", xd, KC), rtol=1e-5,
          atol=1e-6)
    px = rng.uniform([0, 0], [200, 150], (100, 2)).astype(np.float32)
    close(*both("camera", "undistort_points", px, KM, KC), atol=1e-4)
    close(*both("camera", "normalize_points", px, KM, KC))


def test_pixel_maps_and_projection(rng):
    X, R, t = scene(rng, 50, 1)
    px = rng.uniform(0, 200, (50, 2)).astype(np.float32)
    close(*both("camera", "pixel_to_normalized", px, KM))
    close(*both("camera", "normalized_to_pixel", px / 200, KM))
    close(*both("camera", "project_points", KM, R[0], t[0], X), atol=1e-4)
    close(*both("camera", "project_points", KM, R[0], t[0], X, KC),
          atol=1e-4)
    close(*both("camera", "camera_depths", R[0], t[0], X))
    close(*both("camera", "camera_center", R, t))


def test_projection_jacobian_and_cov(rng):
    X, R, t = scene(rng, 40, 1)
    A = rng.standard_normal((40, 3, 3)).astype(np.float32)
    cov = (A @ A.transpose(0, 2, 1) * 1e-3 + 1e-4 * np.eye(3)
           ).astype(np.float32)
    close(*both("camera", "projection_jacobian", KM, R[0], t[0], X),
          rtol=1e-5, atol=1e-4)
    close(*both("camera", "projection_cov", KM, R[0], t[0], X, cov,
                pixel_var=2.0), rtol=1e-4, atol=1e-4)
    d = rng.standard_normal((40, 2)).astype(np.float32)
    S = (A[:, :2, :2] @ A[:, :2, :2].transpose(0, 2, 1)
         + np.eye(2)).astype(np.float32)
    close(*both("camera", "mahalanobis2_2d", d, S), rtol=1e-4)


# -------------------------------------------------------- triangulate ----

def views_of(X, R, t, noise, rng):
    xn = np.einsum("vij,nj->vni", R, X) + t[:, None]
    xn = (xn[..., :2] / xn[..., 2:]).astype(np.float32)
    return (xn + noise * rng.standard_normal(xn.shape)).astype(np.float32)


def test_triangulate_multiview_variants(rng):
    X, R, t = scene(rng, 48, 4)
    xn = views_of(X, R, t, 1e-3, rng)                  # [V, N, 2]
    mask = rng.random((48, 4)) > 0.25
    mask[:, :2] = True
    Rs = np.broadcast_to(R, (48, 4, 3, 3)).copy()
    ts = np.broadcast_to(t, (48, 4, 3)).copy()
    xns = xn.transpose(1, 0, 2).copy()
    close(*both("triangulate", "triangulate_multiview", Rs, ts, xns, mask),
          rtol=EIGH_RT, atol=1e-4)
    close(*both("triangulate", "triangulate_multiview_linear", Rs, ts, xns,
                mask), rtol=1e-4, atol=1e-4)
    w = mask.T.astype(np.float32)
    jX, _ = mods("triangulate")[0].triangulate_multiview_ln(
        R, t, jnp.asarray(xn.transpose(0, 2, 1)), jnp.asarray(w))
    tX, _ = mods("triangulate")[1].triangulate_multiview_ln(
        tp.t(R), tp.t(t), tp.t(xn.transpose(0, 2, 1)), tp.t(w))
    close(np.asarray(jX), tp.n(tX), rtol=1e-4, atol=1e-4)


def test_sym3_solves(rng):
    A = rng.standard_normal((30, 3, 3)).astype(np.float32)
    H = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3)).astype(np.float32)
    close(*both("triangulate", "inv3x3_sym", H), rtol=1e-4, atol=1e-5)
    g = rng.standard_normal((3, 30)).astype(np.float32)
    jm, tm = mods("triangulate")

    def ln(mod, conv):
        Hl = [[conv(H[:, i, j]) for j in range(3)] for i in range(3)]
        return (mod.solve3x3_sym_ln(Hl, [conv(x) for x in g]),
                mod.inv3x3_sym_ln(Hl))
    jo = jax.tree.map(np.asarray, ln(jm, jnp.asarray))
    to = jax.tree.map(tp.n, ln(tm, tp.t), is_leaf=torch.is_tensor)
    close(jo, to, rtol=1e-4, atol=1e-5)


def test_two_view_triangulation(rng):
    X, R, t = scene(rng, 40, 2)
    xn = views_of(X, R, t, 5e-4, rng)
    close(*both("triangulate", "triangulate_two_view", R[0], t[0], R[1],
                t[1], xn[0], xn[1]), rtol=EIGH_RT, atol=1e-4)
    # midpoint: 1 - cos^2 of a few-degree ray angle cancels in float32
    close(*both("triangulate", "triangulate_two_view_midpoint", R[0], t[0],
                R[1], t[1], xn[0], xn[1]), rtol=EIGH_RT, atol=1e-4)
    args = (R[0], t[0], R[1], t[1], xn[0, :, 0], xn[0, :, 1], xn[1, :, 0],
            xn[1, :, 1])
    close(*both("triangulate", "triangulate_two_view_midpoint_ln", *args),
          rtol=EIGH_RT, atol=1e-4)


def test_reprojection_and_covariances(rng):
    X, R, t = scene(rng, 40, 2)
    X[:3, 2] = -X[:3, 2]                                # three behind
    px = rng.uniform(0, 200, (40, 2)).astype(np.float32)
    close(*both("triangulate", "reproj_errors", KM, R[0], t[0], X, px),
          rtol=1e-4, atol=1e-3)
    j, tt = both("triangulate", "is_at_camera_back", R[0], t[0], X)
    np.testing.assert_array_equal(j, tt)
    Ks = np.broadcast_to(KM, (40, 2, 3, 3)).copy()
    Rs = np.broadcast_to(R, (40, 2, 3, 3)).copy()
    ts = np.broadcast_to(t, (40, 2, 3)).copy()
    mask = np.ones((40, 2), bool)
    close(*both("triangulate", "triangulation_cov", Ks, Rs, ts, np.abs(X),
                mask, pixel_var=2.0), rtol=1e-3, atol=1e-6)


def test_seq_triangulate_update(rng):
    X, R, t = scene(rng, 40, 1)
    A = rng.standard_normal((40, 3, 3)).astype(np.float32)
    cov = (A @ A.transpose(0, 2, 1) * 1e-3 + 1e-4 * np.eye(3)
           ).astype(np.float32)
    px = np.asarray(mods("camera")[0].project_points(KM, R[0], t[0], X))
    px = (px + rng.standard_normal(px.shape) * [[1.0]] * np.where(
        np.arange(40) % 5 == 0, 30.0, 0.5)[:, None]).astype(np.float32)
    j, tt = both("triangulate", "seq_triangulate_update", KM, R[0], t[0],
                 px, X, cov, pixel_var=2.0, gate_maha2=9.0)
    close(j, tt, rtol=2e-4, atol=1e-5)


# ----------------------------------------------------------- epipolar ----

def two_view_scene(rng, n=120, outliers=0.2):
    X, R, t = scene(rng, n, 2)
    t[1] = [0.4, 0.05, 0.02]
    xn = views_of(X, R, t, 2e-4, rng)
    bad = rng.random(n) < outliers
    xn[1, bad] += rng.uniform(-0.05, 0.05, (bad.sum(), 2)).astype(np.float32)
    return X, R, t, xn, bad


def test_fit_fundamental_and_sampson(rng):
    X, R, t, xn, bad = two_view_scene(rng, outliers=0.0)
    w = (rng.random(120) > 0.1).astype(np.float32)
    j, tt = both("epipolar", "fit_fundamental", xn[0], xn[1], w)
    # the model is defined up to sign: align before comparing
    tt = tt * np.sign(np.sum(tt * j))
    close(j, tt, rtol=1e-3, atol=1e-4)
    close(*both("epipolar", "sampson_error", j, xn[0], xn[1]), rtol=1e-4,
          atol=1e-10)
    E = np.asarray(mods("epipolar")[0].essential_from_poses(R[0], t[0],
                                                            R[1], t[1]))
    close(*both("epipolar", "essential_from_poses", R[0], t[0], R[1], t[1]),
          atol=1e-5)
    close(*both("epipolar", "fundamental_from_poses", KM, R[0], t[0], KM,
                R[1], t[1]), atol=1e-5)
    close(*both("epipolar", "decompose_essential", E), rtol=1e-4, atol=1e-4)


def test_recover_pose_from_essential(rng):
    X, R, t, xn, _ = two_view_scene(rng, outliers=0.0)
    Rr, tr = np.asarray(mods("se3")[0].relative_pose(R[0], t[0], R[1],
                                                     t[1])[0]), None
    E = np.asarray(mods("epipolar")[0].essential_from_poses(R[0], t[0],
                                                            R[1], t[1]))
    mask = np.ones(120, bool)
    (jR, jt, jX, jg), (tR, tt, tX, tg) = both(
        "epipolar", "recover_pose_from_essential", E, xn[0], xn[1], mask)
    close((jR, jt), (tR, tt), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(jg, tg)
    close(jX[jg], tX[tg], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tR, Rr, atol=1e-3)


@pytest.mark.parametrize("fn", ["ransac_fundamental", "ransac_essential"])
def test_ransac_by_consensus(rng, fn):
    """Different random streams: both packages must find the same
    consensus (the injected outliers rejected, the inliers kept) and a
    model whose recovered pose is the true one."""
    X, R, t, xn, bad = two_view_scene(rng, n=150, outliers=0.25)
    jm, tm = mods("epipolar")
    mask = np.ones(150, bool)
    mask[:5] = False
    thresh = (1.0 / 180.0) ** 2
    jr = getattr(jm, fn)(jax.random.PRNGKey(3), jnp.asarray(xn[0]),
                         jnp.asarray(xn[1]), jnp.asarray(mask),
                         num_hypotheses=256, thresh=thresh)
    tr = getattr(tm, fn)(torch.Generator().manual_seed(3), tp.t(xn[0]),
                         tp.t(xn[1]), tp.t(mask), num_hypotheses=256,
                         thresh=thresh)
    ji, ti = np.asarray(jr.inliers), tp.n(tr.inliers)
    assert int(tr.num_inliers) == int(ti.sum())
    assert not ti[:5].any()
    # judge both against the true geometry: a point is consistent when its
    # Sampson error under the true E is well under the threshold and
    # inconsistent when well over it (an injected outlier can land near
    # its epipolar line); the two packages may differ only in between
    E = jm.essential_from_poses(R[0], t[0], R[1], t[1])
    e_true = np.asarray(jm.sampson_error(E, jnp.asarray(xn[0]),
                                         jnp.asarray(xn[1])))
    good = mask & (e_true < thresh / 4)
    wrong = mask & (e_true > 4 * thresh)
    assert good.sum() > 90 and wrong.sum() > 20
    for inl in (ji, ti):
        assert (inl & good).sum() >= 0.95 * good.sum()
        assert (inl & wrong).sum() <= 1
    assert ((ji != ti) & (good | wrong)).sum() <= 0.03 * good.sum()


def test_ransac_essential_pose_error(rng):
    """Over several scenes the port's essential RANSAC recovers the
    relative rotation as well as the JAX package's does: the winning
    minimal sample differs between the streams, so single runs differ,
    their error distributions must not."""
    jm, tm = mods("epipolar")
    thresh = (1.0 / 180.0) ** 2
    errs = {"jax": [], "port": []}
    for i in range(6):
        X, R, t, xn, bad = two_view_scene(rng, n=150, outliers=0.25)
        mask = np.ones(150, bool)
        Rrel = np.asarray(mods("se3")[0].relative_pose(R[0], t[0], R[1],
                                                       t[1])[0])
        jr = jm.ransac_essential(jax.random.PRNGKey(i), jnp.asarray(xn[0]),
                                 jnp.asarray(xn[1]), jnp.asarray(mask),
                                 num_hypotheses=256, thresh=thresh)
        tr = tm.ransac_essential(torch.Generator().manual_seed(i),
                                 tp.t(xn[0]), tp.t(xn[1]), tp.t(mask),
                                 num_hypotheses=256, thresh=thresh)
        Rj = jm.recover_pose_from_essential(jr.F, jnp.asarray(xn[0]),
                                            jnp.asarray(xn[1]),
                                            jr.inliers)[0]
        Rt = tm.recover_pose_from_essential(tr.F, tp.t(xn[0]), tp.t(xn[1]),
                                            tr.inliers)[0]
        errs["jax"].append(np.abs(np.asarray(Rj) - Rrel).max())
        errs["port"].append(np.abs(tp.n(Rt) - Rrel).max())
    med = {k: float(np.median(v)) for k, v in errs.items()}
    assert med["port"] <= max(2 * med["jax"], 0.01), errs
    assert max(errs["port"]) < 0.1, errs


def test_five_point_same_seed_same_result(rng):
    """The 5-point solver is numpy seeded with default_rng(seed) in both
    packages: with one seed both pick the same samples and agree."""
    X, R, t, xn, bad = two_view_scene(rng, n=100, outliers=0.2)
    valid = np.ones(100, bool)
    jm, tm = mods("fivepoint")
    cj, gj = jm.five_point_candidates(xn[0][None, :5].astype(np.float64),
                                      xn[1][None, :5].astype(np.float64))
    ct, gt = tm.five_point_candidates(xn[0][None, :5].astype(np.float64),
                                      xn[1][None, :5].astype(np.float64))
    np.testing.assert_array_equal(gj, gt)
    np.testing.assert_allclose(ct, cj, atol=1e-9)
    thresh = (1.0 / 180.0) ** 2
    Ej, ij, nj = jm.ransac_essential_5pt(xn[0], xn[1], valid, n_hyp=48,
                                        thresh=thresh, seed=11)
    Et, it, nt = tm.ransac_essential_5pt(xn[0], xn[1], valid, n_hyp=48,
                                        thresh=thresh, seed=11)
    assert nj == nt
    np.testing.assert_array_equal(ij, it)
    np.testing.assert_allclose(Et, Ej, atol=1e-9)
