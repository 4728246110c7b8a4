"""The port's group split and merge end to end (BASELINE config 4):
``coslam_torch``'s CoSlamEngine and ``coslam_tpu``'s on the scene of
tests/test_pipeline_merge.py (two cameras, 150x200, 100 frames; camera 1
yaws ~51 degrees away over frames 20-40, holds, returns over 55-75), both
fed the same frames rendered by the JAX package.

Both runs are held to that file's assertions: the groups split within
frames 45-70, a merge is committed at frame >= 70 with at least 10
map-verified bridge matches (scale sane unless it is a no-op), the groups
are rejoined at the end, camera 0's ATE under 0.15 and camera 1's under
0.65, and the final relative yaw between the cameras within 12 degrees
of the truth. The bridge's RANSAC streams differ (``jax.random`` against a
seeded ``torch.Generator``), so the runs are compared by these outcomes,
not frame by frame."""

import numpy as np
import pytest

import torch_parity as tp

C, F = 2, 100


def _yaw1(f):
    if f < 20:
        return 0.0
    if f < 40:
        return 0.9 * (f - 20) / 20
    if f < 55:
        return 0.9
    if f < 75:
        return 0.9 * (75 - f) / 20
    return 0.0


@pytest.fixture(scope="module")
def runs():
    import jax.numpy as jnp
    from coslam_tpu.config import small_test_config as jcfg
    from coslam_tpu.geometry.se3 import so3_exp
    from coslam_tpu.io.synthetic import make_room, render
    from coslam_tpu.slam.pipeline import CoSlamEngine as JEngine
    from coslam_torch.config import small_test_config as tcfg
    from coslam_torch.slam.pipeline import CoSlamEngine as TEngine
    planes = make_room(np.random.default_rng(1), size=10.0)
    Rs_gt = np.zeros((C, F, 3, 3), np.float32)
    ts_gt = np.zeros((C, F, 3), np.float32)
    frames = np.zeros((F, C, tp.H, tp.W), np.float32)
    for f in range(F):
        base_c = np.array([0.0, 0.0, 0.02 * f], np.float32)
        for c in range(C):
            yaw = _yaw1(f) if c == 1 else 0.0
            Rc = np.asarray(so3_exp(jnp.array([0.0, yaw, 0.0], jnp.float32)))
            center = base_c + np.array([c * 1.0 - 0.5, 0, 0], np.float32)
            Rs_gt[c, f] = Rc
            ts_gt[c, f] = -Rc @ center
            frames[f, c] = np.asarray(render(planes, tp.KMAT[0], Rc,
                                             ts_gt[c, f], tp.H, tp.W))
    K, kc = tp.kmats(C)
    out = {}
    for name, eng in (("jax", JEngine(jcfg(C, tp.H, tp.W), K, kc)),
                      ("port", TEngine(tcfg(C, tp.H, tp.W), K, kc,
                                       device="cpu"))):
        groups = []
        for f in range(F):
            eng.process_frame(frames[f])
            groups.append(tuple(eng.group_id.tolist()))
        trajs = [tuple(np.asarray(a) for a in eng.trajectory(c, True))
                 for c in range(C)]
        out[name] = dict(groups=groups, merge_log=list(eng.merge_log),
                         trajs=trajs)
        print(f"{name}: merges {eng.merge_log}; group transitions "
              f"{[(i, g) for i, g in enumerate(groups) if i and g != groups[i - 1]]}")
    return out, Rs_gt, ts_gt


@pytest.mark.parametrize("which", ["jax", "port"])
def test_group_splits_during_separation(runs, which):
    groups = runs[0][which]["groups"]
    assert any(g[0] != g[1] for g in groups[45:70])


@pytest.mark.parametrize("which", ["jax", "port"])
def test_merge_happens_on_reoverlap(runs, which):
    log = runs[0][which]["merge_log"]
    assert len(log) >= 1
    m = log[-1]
    assert m["frame"] >= 70
    if m.get("noop"):
        assert m["scale_move"] == 1.0
    else:
        assert 0.3 < m["scale"] < 3.0
    assert m["n_matches"] >= 10


@pytest.mark.parametrize("which", ["jax", "port"])
def test_groups_rejoined_at_end(runs, which):
    g = runs[0][which]["groups"][-1]
    assert g[0] == g[1]


@pytest.mark.parametrize("which", ["jax", "port"])
def test_post_merge_alignment(runs, which):
    from coslam_torch.io.ate import ate_rmse
    out, Rs_gt, ts_gt = runs
    (R0, t0), (R1, t1) = out[which]["trajs"]
    a0 = ate_rmse(R0, t0, Rs_gt[0], ts_gt[0])
    a1 = ate_rmse(R1, t1, Rs_gt[1], ts_gt[1])
    print(f"{which}: ATE {a0:.4f} {a1:.4f}")
    assert a0 < 0.15, a0
    assert a1 < 0.65, a1
    R_rel = R1[-1] @ R0[-1].T
    R_rel_gt = Rs_gt[1, -1] @ Rs_gt[0, -1].T
    ang = np.degrees(np.arccos(np.clip(
        (np.trace(R_rel @ R_rel_gt.T) - 1) / 2, -1, 1)))
    assert ang < 12.0, ang


def test_same_merge_outcome(runs):
    """The port merges on the same grouping tick as the JAX package, or
    one tick apart, with the same kind of merge (no-op or realigning)."""
    out = runs[0]
    mj, mt = out["jax"]["merge_log"][-1], out["port"]["merge_log"][-1]
    assert abs(mj["frame"] - mt["frame"]) <= 5
    assert bool(mj.get("noop")) == bool(mt.get("noop"))
