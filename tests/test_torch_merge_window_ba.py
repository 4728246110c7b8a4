"""The merge-time wide-window BA of the port against the JAX package's
(tests/test_merge_window_ba.py, ported): ``steps.build_ba_table(window=)``,
``bundle_adjust_table`` and ``apply_ba_table_results`` on the same drifted
state (that file's ``_drifted_state``: 10 keyframes of one camera,
keyframes 3-7 and the points perturbed), built by the JAX package and
carried over as numpy.

The port's solve is held to the JAX test's assertions (the wide window
corrects the mid-separation keyframes, the default window cannot reach
keyframe 3), and what it writes back to the JAX package's: keyframe
rotation entries within 1e-4, translations and points within 1e-3
(measured: 2.7e-6, 2.1e-5 and 1.4e-5; float32 sums in another order over
60 inner iterations).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import torch_parity as tp
from test_merge_window_ba import PERTURB, W_TOTAL, _drifted_state, _kf_err


def _port_cfg():
    from coslam_torch.config import small_test_config
    cfg = small_test_config(num_cameras=1)
    return cfg.replace(cap=dataclasses.replace(cfg.cap, ba_window=5,
                                               max_keyframes=16))


def _run_port(state, K1, cfg, window):
    from coslam_torch.slam import steps
    from coslam_torch.solvers.ba import bundle_adjust_table
    prob, ring, kf_ok = steps.build_ba_table(state, tp.t(K1[None]), cfg,
                                             window=window)
    res = bundle_adjust_table(prob, max_err=cfg.p.max_err, max_iter=2,
                              inner_iter=30)
    return steps.apply_ba_table_results(state, res, ring, kf_ok, cfg)


def _run_jax(state, K1, cfg, window):
    from coslam_tpu.slam import steps
    from coslam_tpu.solvers.ba import bundle_adjust_table
    prob, ring, kf_ok = steps.build_ba_table(state, jnp.asarray(K1[None]),
                                             cfg, window=window)
    res = bundle_adjust_table(prob, max_err=cfg.p.max_err, max_iter=2,
                              inner_iter=30)
    return steps.apply_ba_table_results(state, res, ring, kf_ok, cfg)


@pytest.fixture(scope="module")
def runs():
    from coslam_torch.slam.state import state_from_numpy
    jcfg, jst, R_gt, t_gt, K1 = _drifted_state(np.random.default_rng(0))
    tcfg = _port_cfg()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tst = state_from_numpy(tp.to_numpy(jst), "cpu")
    out = dict(gt=(R_gt, t_gt), start=tst)
    for name, window in (("narrow", None), ("wide", jcfg.p.merge_ba_window)):
        out[name] = (tp.to_numpy(_run_jax(jst, K1, jcfg, window)),
                     _run_port(tst, K1, tcfg, window))
    return out


def _port_err(state, R_gt, t_gt):
    """``_kf_err`` of a port state."""
    return _kf_err(state._replace(kfs=state.kfs._replace(
        R=tp.n(state.kfs.R), t=tp.n(state.kfs.t))), R_gt, t_gt)


def test_wide_window_corrects_mid_separation_keyframes(runs):
    """tests/test_merge_window_ba.py's assertions, on the port's solve."""
    R_gt, t_gt = runs["gt"]
    err0 = _port_err(runs["start"], R_gt, t_gt)
    assert err0 > 0.05
    st_narrow, st_wide = runs["narrow"][1], runs["wide"][1]
    err_narrow = _port_err(st_narrow, R_gt, t_gt)
    err_wide = _port_err(st_wide, R_gt, t_gt)
    assert err_wide < 0.2 * err0, (err0, err_wide)
    assert err_wide < 0.5 * err_narrow, (err_narrow, err_wide)
    e3 = np.abs(tp.n(st_narrow.kfs.R[3, 0]) - R_gt[3]).max()
    assert e3 > 0.01


@pytest.mark.parametrize("window", ["narrow", "wide"])
def test_window_ba_against_jax(runs, window):
    """Every keyframe pose and map point the two packages write back, on
    the same drifted state."""
    jst, tst = runs[window]
    np.testing.assert_allclose(tp.n(tst.kfs.R)[:W_TOTAL],
                               np.asarray(jst.kfs.R)[:W_TOTAL], atol=1e-4)
    np.testing.assert_allclose(tp.n(tst.kfs.t)[:W_TOTAL],
                               np.asarray(jst.kfs.t)[:W_TOTAL], atol=1e-3)
    np.testing.assert_array_equal(tp.n(tst.mappts.status),
                                  np.asarray(jst.mappts.status))
    alive = np.asarray(jst.mappts.status) == 1
    np.testing.assert_allclose(tp.n(tst.mappts.xyz)[alive],
                               np.asarray(jst.mappts.xyz)[alive], atol=1e-3)
    moved = [m for m in PERTURB
             if np.abs(np.asarray(jst.kfs.R[m, 0])
                       - tp.n(runs["start"].kfs.R[m, 0])).max() > 1e-3]
    assert moved, "the solve moved none of the drifted keyframes"
