"""Solver parity: ``coslam_torch.solvers`` (IRLS pose, dense-table BA, the
chain pose graph) against ``coslam_tpu.solvers`` on the same problems.

Tolerances: the solvers iterate in float32, and XLA and PyTorch reorder
the sums of their normal equations, so the iterates drift apart by a few
ulps per step. Poses agree to 1e-4 (rotation entries) and 1e-4 of the
scene scale (translations), points to 1e-3 of the scene scale; the
pose graph's single dense solve agrees to 1e-4."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_parity as tp

KP = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def so3(w):
    from coslam_tpu.geometry.se3 import so3_exp
    return np.asarray(so3_exp(jnp.asarray(np.asarray(w, np.float32))))


def pose_problem(rng, n=200, noise=0.3, outlier_frac=0.2):
    X = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    X[:, 2] += 8.0
    R = so3([0.2, -0.1, 0.15])
    t = np.array([0.3, -0.2, 0.5], np.float32)
    Xc = X @ R.T + t
    px = (Xc[:, :2] / Xc[:, 2:3]) * 500.0 + np.array([320.0, 240.0])
    px = (px + noise * rng.standard_normal((n, 2))).astype(np.float32)
    n_out = int(outlier_frac * n)
    px[:n_out] += rng.uniform(30, 100, (n_out, 2)).astype(np.float32)
    R0 = so3([0.03, 0.02, -0.04]) @ R
    t0 = (t + np.array([0.1, -0.05, 0.2])).astype(np.float32)
    return X, px, R0.astype(np.float32), t0


@pytest.mark.parametrize("n_irls,n_lm", [(5, 10), (4, 8)])
def test_irls_pose_matches(rng, n_irls, n_lm):
    from coslam_tpu.solvers.pose import irls_pose as jirls
    from coslam_torch.solvers.pose import irls_pose as tirls
    X, px, R0, t0 = pose_problem(rng)
    valid = rng.random(200) > 0.05
    jr = jirls(jnp.asarray(KP), jnp.asarray(R0), jnp.asarray(t0),
               jnp.asarray(X), jnp.asarray(px), jnp.asarray(valid), 10.0,
               n_irls, n_lm)
    tr = tirls(tp.t(KP), tp.t(R0), tp.t(t0), tp.t(X), tp.t(px),
               tp.t(valid), 10.0, n_irls=n_irls, n_lm=n_lm)
    np.testing.assert_allclose(tp.n(tr.R), np.asarray(jr.R), atol=1e-4)
    np.testing.assert_allclose(tp.n(tr.t), np.asarray(jr.t), atol=1e-4)
    np.testing.assert_array_equal(tp.n(tr.weights) > 0,
                                  np.asarray(jr.weights) > 0)
    np.testing.assert_allclose(tp.n(tr.weights), np.asarray(jr.weights),
                               atol=1e-3)
    np.testing.assert_allclose(tp.n(tr.err), np.asarray(jr.err), rtol=1e-3,
                               atol=1e-3)


def test_irls_pose_camera_batch_matches_vmap(rng):
    """The port batches cameras on a leading axis where the JAX package
    vmaps: both give each camera's own solve."""
    from coslam_tpu.solvers.pose import irls_pose as jirls
    from coslam_torch.solvers.pose import irls_pose as tirls
    probs = [pose_problem(rng, outlier_frac=f) for f in (0.0, 0.3)]
    X, px, R0, t0 = (np.stack(a) for a in zip(*probs))
    valid = np.ones((2, 200), bool)
    Ks = np.stack([KP, KP])
    jr = jax.vmap(lambda *a: jirls(*a, 10.0, 4, 8))(
        *(jnp.asarray(a) for a in (Ks, R0, t0, X, px, valid)))
    tr = tirls(*(tp.t(a) for a in (Ks, R0, t0, X, px, valid)), 10.0,
               n_irls=4, n_lm=8)
    np.testing.assert_allclose(tp.n(tr.R), np.asarray(jr.R), atol=1e-4)
    np.testing.assert_allclose(tp.n(tr.t), np.asarray(jr.t), atol=1e-4)


def test_chol_solve6(rng):
    from coslam_tpu.solvers.pose import _chol_solve6 as jc
    from coslam_torch.solvers.pose import _chol_solve6 as tc
    A = rng.standard_normal((5, 6, 6)).astype(np.float32)
    A = (A @ A.transpose(0, 2, 1) + np.eye(6)).astype(np.float32)
    b = rng.standard_normal((5, 6)).astype(np.float32)
    want = np.stack([np.asarray(jc(jnp.asarray(A[i]), jnp.asarray(b[i])))
                     for i in range(5)])
    np.testing.assert_allclose(tp.n(tc(tp.t(A), tp.t(b))), want, rtol=1e-4,
                               atol=1e-5)


def ba_problem(rng, S=6, P=96, drop=0.3, corrupt=False):
    X = rng.uniform(-3, 3, (P, 3)).astype(np.float32)
    X[:, 2] += 9
    Rs = np.stack([so3(0.05 * rng.standard_normal(3)) for _ in range(S)])
    ts = np.stack([np.array([0.4 * m, 0.05 * m, 0.0], np.float32)
                   for m in range(S)])
    valid = rng.random((S, P)) > drop
    px = np.zeros((S, 2, P), np.float32)
    K1 = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
    for s in range(S):
        Xc = X @ Rs[s].T + ts[s]
        px[s, 0] = Xc[:, 0] / Xc[:, 2] * 300 + 160
        px[s, 1] = Xc[:, 1] / Xc[:, 2] * 300 + 120
    px += (0.3 * rng.standard_normal(px.shape)).astype(np.float32)
    if corrupt:
        px[3, 0, :10] += 40.0
    cam_fixed = np.zeros(S, bool)
    cam_fixed[:2] = True
    Rp = Rs.copy()
    for m in range(2, S):
        Rp[m] = so3(0.02 * rng.standard_normal(3)) @ Rs[m]
    Xp = (X + 0.05 * rng.standard_normal(X.shape)).astype(np.float32)
    point_fixed = rng.random(P) < 0.1
    return dict(K=np.broadcast_to(K1, (S, 3, 3)).copy(), R=Rp, t=ts, X=Xp,
                obs_px=px, obs_valid=valid, cam_fixed=cam_fixed,
                point_fixed=point_fixed)


@pytest.mark.parametrize("corrupt", [False, True])
def test_bundle_adjust_table_matches(rng, corrupt):
    from coslam_tpu.solvers.ba import BATableProblem as JP
    from coslam_tpu.solvers.ba import bundle_adjust_table as jba
    from coslam_torch.solvers.ba import BATableProblem as TP
    from coslam_torch.solvers.ba import bundle_adjust_table as tba
    prob = ba_problem(rng, corrupt=corrupt)
    jr = jba(JP(**{k: jnp.asarray(v) for k, v in prob.items()}),
             max_err=6.0, max_iter=2, inner_iter=15)
    tr = tba(TP(**{k: tp.t(v) for k, v in prob.items()}), max_err=6.0,
             max_iter=2, inner_iter=15)
    assert set(tr._fields) == set(jr._fields)
    np.testing.assert_allclose(tp.n(tr.R), np.asarray(jr.R), atol=1e-4)
    np.testing.assert_allclose(tp.n(tr.t), np.asarray(jr.t), atol=1e-3)
    # a point seen once is free along its ray (only the damping holds its
    # depth), so its position is compared only where two views fix it
    obs2 = prob["obs_valid"].sum(0) >= 2
    np.testing.assert_allclose(tp.n(tr.X)[obs2], np.asarray(jr.X)[obs2],
                               atol=1e-2)
    jo, to = np.asarray(jr.obs_outlier), tp.n(tr.obs_outlier)
    assert (jo != to).sum() <= 2
    if corrupt:
        assert to[3, :10].sum() >= 0.8 * prob["obs_valid"][3, :10].sum()
    np.testing.assert_array_equal(tp.n(tr.obs_valid), np.asarray(jr.obs_valid))
    np.testing.assert_allclose(tp.n(tr.obs_err)[:, obs2],
                               np.asarray(jr.obs_err)[:, obs2], rtol=1e-2,
                               atol=1e-3)
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-2)


def chain_problem(rng, F=40, anchors=(0, 9, 20, 31, 39)):
    Rs = [np.eye(3, dtype=np.float32)]
    ts = [np.zeros(3, np.float32)]
    for _ in range(F - 1):
        dR = so3(0.02 * rng.standard_normal(3))
        Rs.append((dR @ Rs[-1]).astype(np.float32))
        ts.append((dR @ ts[-1] + [0.05, 0.0, 0.01]).astype(np.float32))
    Rs, ts = np.stack(Rs), np.stack(ts)
    R_rel = np.einsum("fij,fkj->fik", Rs[1:], Rs[:-1])
    t_rel = ts[1:] - np.einsum("fij,fj->fi", R_rel, ts[:-1])
    R_rel = np.stack([so3(0.003 * rng.standard_normal(3)) @ r
                      for r in R_rel]).astype(np.float32)
    t_rel = (t_rel * 1.1 + 0.002 * rng.standard_normal(t_rel.shape)
             ).astype(np.float32)
    fixed = np.zeros(F, bool)
    fixed[list(anchors)] = True
    return R_rel, t_rel, fixed, Rs, ts


@pytest.mark.parametrize("scales", [False, True])
def test_chain_pose_graph_matches(rng, scales):
    from coslam_tpu.solvers import pose_graph as jpg
    from coslam_torch.solvers import pose_graph as tpg
    R_rel, t_rel, fixed, Rs, ts = chain_problem(rng)
    F = fixed.shape[0]
    nv = np.ones(F, bool)
    args = (R_rel, t_rel, fixed, Rs, ts, nv)
    jg = jpg.chain_graph(*(jnp.asarray(a) for a in args))
    tg = tpg.chain_graph(*(tp.t(a) for a in args))
    G = 1
    if scales:
        anchors = np.nonzero(fixed)[0]
        seg = np.searchsorted(anchors, np.arange(F - 1), side="right") - 1
        sg = np.where(np.arange(F - 1) < anchors[-1], seg, -1).astype(
            np.int32)
        G = len(anchors) - 1
        jg = jg._replace(scale_group=jnp.asarray(sg))
        tg = tg._replace(scale_group=tp.t(sg))
    jR, tR = jpg.solve_rotations(jg), tpg.solve_rotations(tg)
    np.testing.assert_allclose(tp.n(tR), np.asarray(jR), atol=1e-4)
    jt, js = jpg.solve_translations(jg, jR, num_scales=G)
    tt, tsc = tpg.solve_translations(tg, tR, num_scales=G)
    np.testing.assert_allclose(tp.n(tt), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(tp.n(tsc), np.asarray(js), atol=1e-4)


@pytest.mark.parametrize("scales", [False, True])
def test_solve_chain_segments_matches(rng, scales):
    from coslam_tpu.solvers.pose_graph import solve_chain_segments as js
    from coslam_torch.solvers.pose_graph import solve_chain_segments as ts_
    R_rel, t_rel, fixed, Rs, ts = chain_problem(
        rng, F=70, anchors=(0, 3, 4, 30, 52))       # a rigid tail after 52
    jR, jt = js(R_rel, t_rel, fixed, Rs, ts, chain_scales=scales)
    tR, tt = ts_(R_rel, t_rel, fixed, Rs, ts, chain_scales=scales,
                 device="cpu")
    np.testing.assert_allclose(tR, np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt, np.asarray(jt), atol=1e-4)


@pytest.mark.parametrize("cam_fixed", [(False, False), (True, False)])
def test_schur_solve_of_a_singular_system(cam_fixed):
    """An exactly singular reduced camera system (no damping, no
    information) gives a non-finite step, as the JAX package's
    ``jnp.linalg.solve`` does, which bundle_adjust rejects; it does not
    raise (``torch.linalg.solve`` raises on a singular matrix, which
    stopped the map init on the card)."""
    import jax.numpy as jnp
    from coslam_tpu.solvers.ba import _schur_solve as jsolve
    from coslam_torch.solvers.ba import _schur_solve
    M, P = 2, 3
    fixed = np.array(cam_fixed)
    args = [np.zeros(s, np.float32) for s in
            ((M, 6, 6), (P, M, 6, 3), (P, 3, 3), (M, 6), (P, 3))]
    want = jsolve(*map(jnp.asarray, args), 0.0, jnp.asarray(fixed),
                  jnp.zeros(P, bool))
    got = _schur_solve(*map(tp.t, args), 0.0, tp.t(fixed),
                       torch.zeros(P, dtype=torch.bool))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isfinite(tp.n(g)),
                                      np.isfinite(np.asarray(w)))
    assert not np.isfinite(tp.n(got[0])).all()
