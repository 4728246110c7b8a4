"""The port's intra-group loop closure end to end: ``coslam_torch``'s
CoSlamEngine and ``coslam_tpu``'s on the scene of
tests/test_loop_closure.py (one camera, 150x200, 88 frames: a lateral
sweep maps the back wall, a yaw out to ~66 degrees lets its points go
dormant, the yaw back and a dwell revisit them), with that file's closure
thresholds (dormant after 30 frames, closures 20 frames apart, 12 dormant
projections to try, 7 inliers to commit), both fed the same frames
rendered by the JAX package.

Held to that file's assertions: both commit a closure anchored on the old
map (f_anchor < frame - 20) with at least 7 inliers, the port's map is
finite with more than 40 points, and the port's ATE is no worse than the
JAX run's x 1.10 + 1e-3 (the bound test_closure_does_not_corrupt puts on
closure against no closure). The closures' first frames lie at most one
grouping tick apart."""

import dataclasses

import numpy as np
import pytest

import torch_parity as tp

F = 88


@pytest.fixture(scope="module")
def runs():
    import jax.numpy as jnp
    from coslam_tpu.config import small_test_config as jcfg
    from coslam_tpu.geometry.se3 import so3_exp
    from coslam_tpu.io.synthetic import make_room, render_sequence
    from coslam_tpu.slam.pipeline import CoSlamEngine as JEngine
    from coslam_torch.config import small_test_config as tcfg
    from coslam_torch.io.ate import ate_rmse
    from coslam_torch.slam.pipeline import CoSlamEngine as TEngine
    yaws = np.concatenate([np.zeros(20), np.linspace(0, 1.15, 25),
                           np.full(14, 1.15), np.linspace(1.15, 0.0, 13),
                           np.zeros(F - 72)])
    Rs, ts = [], []
    for f in range(F):
        R = np.asarray(so3_exp(jnp.array([0.0, yaws[f], 0.0], jnp.float32)))
        c = np.array([0.35 * np.sin(0.16 * f), 0.02 * np.sin(0.1 * f),
                      0.004 * f], np.float32)
        Rs.append(R)
        ts.append((-R @ c).astype(np.float32))
    Rs_gt, ts_gt = np.stack(Rs), np.stack(ts)
    planes = make_room(np.random.default_rng(0), size=10.0)
    frames = np.asarray(render_sequence(planes, tp.KMAT[0], Rs_gt, ts_gt,
                                        tp.H, tp.W))

    def loop_cfg(cfg):
        return cfg.replace(p=dataclasses.replace(
            cfg.p, loop_dormant_age=30, loop_min_interval=20,
            loop_overlap_min=12, loop_min_inliers=7))

    out = {}
    for name, eng in (("jax", JEngine(loop_cfg(jcfg(1, tp.H, tp.W)),
                                      tp.KMAT, tp.KC)),
                      ("port", TEngine(loop_cfg(tcfg(1, tp.H, tp.W)),
                                       tp.KMAT, tp.KC, device="cpu"))):
        for f in range(F):
            eng.process_frame(frames[f][None])
        R, t = (np.asarray(a) for a in eng.trajectory(0, correct=True))
        ids, xyz, cov = eng.map_points()
        out[name] = dict(loop_log=list(eng.loop_log),
                         ate=ate_rmse(R, t, Rs_gt, ts_gt),
                         map=(np.asarray(ids), np.asarray(xyz),
                              np.asarray(cov)))
        print(f"{name}: loops {eng.loop_log}; ATE {out[name]['ate']:.4f}")
    return out


@pytest.mark.parametrize("which", ["jax", "port"])
def test_closure_fires(runs, which):
    log = runs[which]["loop_log"]
    assert log, "no loop closure committed"
    lc = log[0]
    assert lc["n_inliers"] >= 7
    assert lc["f_anchor"] < lc["frame"] - 20


def test_first_closures_one_tick_apart(runs):
    assert abs(runs["jax"]["loop_log"][0]["frame"]
               - runs["port"]["loop_log"][0]["frame"]) <= 5


def test_closure_does_not_corrupt(runs):
    ate, ref = runs["port"]["ate"], runs["jax"]["ate"]
    assert ate <= ref * 1.10 + 1e-3, (ate, ref)


def test_map_still_finite(runs):
    ids, xyz, cov = runs["port"]["map"]
    assert np.isfinite(xyz).all() and np.isfinite(cov).all()
    assert len(ids) > 40
