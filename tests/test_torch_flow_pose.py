"""Parity of two small ports against the JAX package: TV-L1 flow
(``ops/flow.py``, which the pipeline does not call) and the epipolar-
augmented pose solver ``solvers/pose.py::irls_pose_epi``, plus their
anchors (tests/test_ops_frontend.py::test_tvl1_flow_translation and
tests/test_solvers.py::test_irls_pose_epi_rescues_sparse_3d) on the port.

Bands: the flow agrees with the JAX function within 1e-4 px everywhere
(the iterations run the same float32 operations in the same order; the
measured gap is 3e-5 px on the translation case, 7e-6 on the two-camera
case); the pose within 1e-5 per rotation entry and 1e-4 in
translation."""

import numpy as np
import pytest
import torch

import torch_parity as tp

FLOW_TOL = 1e-4


def _rot_deg(Ra, Rb):
    d = np.asarray(Ra) @ np.asarray(Rb).T
    return np.degrees(np.arccos(np.clip((np.trace(d) - 1) / 2, -1, 1)))


def _translated(rng, h=64, w=80, dx=3.0, dy=-2.0):
    img0 = tp.smooth_texture(rng, h, w)
    return img0, tp.shift_image(img0, dx, dy)


def test_tvl1_flow_translation(rng):
    """The port recovers a uniform translation (the anchor's settings)."""
    from coslam_torch.ops.flow import tvl1_flow
    img0, img1 = _translated(rng)
    flow = tvl1_flow(tp.t(img0), tp.t(img1), n_levels=3, n_warps=5,
                     n_iters=30, lam=0.5)
    assert flow.shape == (1, 64, 80, 2)
    inner = tp.n(flow[0, 12:-12, 12:-12])
    med = np.median(inner.reshape(-1, 2), axis=0)
    np.testing.assert_allclose(med, [3.0, -2.0], atol=0.5)


@pytest.mark.parametrize("case", ["translation", "two_cameras_default"])
def test_tvl1_flow_matches_jax(rng, case):
    from coslam_tpu.ops.flow import tvl1_flow as jflow
    from coslam_torch.ops.flow import tvl1_flow
    if case == "translation":
        img0, img1 = _translated(rng)
        kw = dict(n_levels=3, n_warps=5, n_iters=30, lam=0.5)
    else:
        img0 = np.concatenate([tp.smooth_texture(rng, 48, 64)
                               for _ in range(2)])
        img1 = np.concatenate([tp.shift_image(img0[i:i + 1], 1.5 * i + 0.5,
                                              -1.0) for i in range(2)])
        kw = {}
    want = np.asarray(jflow(img0, img1, **kw))
    got = tp.n(tvl1_flow(tp.t(img0), tp.t(img1), **kw))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FLOW_TOL


def _epi_problem(rng):
    """The inputs of tests/test_solvers.py::test_irls_pose_epi_rescues_
    sparse_3d: 150 points, 8 of them mapped, the previous pose a small
    motion before the current one."""
    from coslam_torch.geometry.se3 import so3_exp
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    n = 150
    X = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    X[:, 2] += 8.0
    R = tp.n(so3_exp(torch.tensor([0.2, -0.1, 0.15])))
    t = np.array([0.3, -0.2, 0.5], np.float32)
    Xc = X @ R.T + t
    px = (Xc[:, :2] / Xc[:, 2:3]) * 500.0 + np.array([320.0, 240.0])
    px = px.astype(np.float32) + 0.2 * rng.standard_normal(
        (n, 2)).astype(np.float32)
    dR = tp.n(so3_exp(torch.tensor([0.01, -0.02, 0.01])))
    R_prev = (dR.T @ R).astype(np.float32)
    t_prev = t - np.array([0.05, 0.0, 0.02], np.float32)
    Xc_prev = X @ R_prev.T + t_prev
    px_prev = ((Xc_prev[:, :2] / Xc_prev[:, 2:3]) * 500.0
               + np.array([320.0, 240.0])).astype(np.float32)
    valid3 = np.zeros(n, bool)
    valid3[:8] = True
    valid2 = np.ones(n, bool)
    args = (K, R_prev, t_prev, X, px, valid3, R_prev, t_prev, px_prev,
            valid2)
    return args, R, t


def test_irls_pose_epi_rescues_sparse_3d(rng):
    """The anchor on the port: 8 mapped points plus the epipolar terms pin
    the pose, no worse than the plain solver from the same start."""
    from coslam_torch.solvers.pose import irls_pose, irls_pose_epi
    args, R, t = _epi_problem(rng)
    res = irls_pose_epi(*(tp.t(a) for a in args), 10.0)
    assert _rot_deg(tp.n(res.R), R) < 0.2
    np.testing.assert_allclose(tp.n(res.t), t, atol=0.05)
    K, R0, t0, X, px, valid3 = (tp.t(a) for a in args[:6])
    res0 = irls_pose(K, R0, t0, X, px, valid3, 10.0)
    assert _rot_deg(tp.n(res.R), R) <= _rot_deg(tp.n(res0.R), R) + 0.05


@pytest.mark.parametrize("epi_weight", [1.0, 0.5])
def test_irls_pose_epi_matches_jax(rng, epi_weight):
    import jax.numpy as jnp
    from coslam_tpu.solvers.pose import irls_pose_epi as jepi
    from coslam_torch.solvers.pose import irls_pose_epi
    args, _, _ = _epi_problem(rng)
    want = jepi(*(jnp.asarray(a) for a in args), 10.0,
                epi_weight=epi_weight)
    got = irls_pose_epi(*(tp.t(a) for a in args), 10.0,
                        epi_weight=epi_weight)
    np.testing.assert_allclose(tp.n(got.R), np.asarray(want.R), atol=1e-5)
    np.testing.assert_allclose(tp.n(got.t), np.asarray(want.t), atol=1e-4)
    np.testing.assert_array_equal(tp.n(got.weights) > 0,
                                  np.asarray(want.weights) > 0)
    np.testing.assert_allclose(tp.n(got.err), np.asarray(want.err),
                               atol=1e-2)
