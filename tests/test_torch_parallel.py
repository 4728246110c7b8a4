"""The port's multi-device layer (``coslam_torch/parallel``, the fused
step's ``mesh=``) on a CPU mesh, against the JAX package's on its eight
virtual CPU devices (tests/conftest.py) and against the port's own
single-device code. The chunked mesh step's tests are in
tests/test_torch_parallel_chunk.py.

The port's mesh is ``["cpu"] * n``: one controller, the shards' work run
one after the other on the CPU. Each shard's arithmetic is the
single-device step's on a camera block, so the mesh step equals the
port's single-device step exactly. Against the JAX package the bands are
those of the single-device parity tests: the KLT bands of
tests/test_torch_ops.py on one step from the same seeded table, the pose
bands of tests/test_torch_engine.py, and the BA tolerances of
tests/test_parallel.py (R and t within 5e-4, X within 5e-3).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

import torch_parity as tp

H, W, FEATS = tp.MESH_H, tp.MESH_W, tp.MESH_FEATS


@pytest.fixture(scope="module")
def step8():
    """One fused step at C = 8 from the same seeded table: the JAX
    package's on its 8-device mesh, the port's on ["cpu"] * 8 and on one
    device."""
    from coslam_torch.parallel.mesh import make_cam_mesh
    from coslam_torch.parallel.scaling import mesh_cfg
    from coslam_torch.slam.fused import frame_step, shard_frames
    from coslam_tpu.parallel.mesh import shard_state
    from coslam_tpu.slam.fused import frame_step as jstep
    C = 8
    imgs, K, kc = tp.mesh_images(C)
    cur = np.roll(imgs, 1, axis=-1)
    jcfg, seeded, pyr0 = tp.jax_seeded(C, imgs, K, kc)
    from coslam_tpu.slam.state import SlamState
    from coslam_tpu.ops.pyramid import Pyramid as JPyr
    jmesh = Mesh(np.array(jax.devices()[:C]), ("cam",))
    js = shard_state(jax.tree.map(jnp.asarray, SlamState(*seeded)), jmesh)
    jpyr = jax.tree.map(jnp.asarray, JPyr(*pyr0))
    js, _, jfs = jstep(js, jpyr, jnp.asarray(cur), jnp.asarray(K),
                       jnp.asarray(kc), jcfg, mesh=jmesh)
    tcfg = mesh_cfg(C, H, W, FEATS)
    mesh = make_cam_mesh(devices=["cpu"] * C)
    st, pyr, tK, tkc = tp.port_mesh_start(mesh, seeded, pyr0, K, kc)
    mesh.reset_census()
    ts, tpyr, tfs = frame_step(st, pyr, shard_frames(mesh, tp.t(cur)), tK,
                               tkc, tcfg, mesh=mesh)
    census = dict(mesh.census)
    s1, p1, tK1, tkc1 = tp.port_single_start(seeded, pyr0, K, kc)
    ss, spyr, sfs = frame_step(s1, p1, tp.t(cur), tK1, tkc1, tcfg)
    return dict(jax=(tp.to_numpy(js), tp.to_numpy(jfs)), mesh=(ts, tpyr, tfs),
                single=(ss, spyr, sfs), census=census, C=C)


def _assert_step_against_jax(jstate, jfs, tstate, tfs):
    """One step from the same seeded table: track tables in the KLT bands
    (at most one flip a camera, positions to 1e-3 px, integer fields equal
    where both keep a feature), the stats' counts equal, poses in the
    bands of tests/test_torch_engine.py."""
    C = tstate.tracks.valid.shape[0]
    tp.assert_tracks_close(jstate.tracks, tstate.tracks, max_flips=C,
                           pos_tol=1e-3)
    for k in ("n_tracked", "n_inliers", "n_mapped"):
        np.testing.assert_array_equal(tp.n(getattr(tfs, k)),
                                      np.asarray(getattr(jfs, k)), err_msg=k)
    for k in ("n_new_points", "n_static", "n_dynamic"):
        assert int(tp.n(getattr(tfs, k))) == int(np.asarray(getattr(jfs, k)))
    np.testing.assert_allclose(tp.n(tfs.R), np.asarray(jfs.R), atol=2e-3)
    np.testing.assert_allclose(tp.n(tfs.t), np.asarray(jfs.t), atol=5e-3)
    assert int(tstate.frame) == int(jstate.frame)


def test_mesh_step_against_jax_mesh_step(step8):
    (jstate, jfs), (ts, _, tfs) = step8["jax"], step8["mesh"]
    assert tp.n(tfs.n_tracked).min() > 10
    _assert_step_against_jax(jstate, jfs, ts, tfs)


def test_mesh_step_equals_single_device_step(step8):
    """The mesh step and the single-device step of the port on the same
    inputs: every state leaf, the stats and the carried pyramid equal."""
    from coslam_torch.slam.fused import pack_stats
    (ts, tpyr, tfs), (ss, spyr, sfs) = step8["mesh"], step8["single"]
    tp.assert_states_equal(ts, ss)
    np.testing.assert_array_equal(tp.n(pack_stats(tfs)), tp.n(pack_stats(sfs)))
    full = tpyr.gather_levels()
    for a, b in zip(tp.leaves(tuple(full)), tp.leaves(tuple(spyr))):
        assert torch.equal(a, b)


def test_step_transfer_census(step8):
    """Each shard receives its 11 track rows once and returns them and one
    NCC block pair once: 2 x 11 + 2 transfers a shard, nothing else (the
    JAX package's one boundary gather set, tests/test_scaling_harness.py).
    audit_step_transfers counts the same over its own step."""
    from coslam_torch.parallel.scaling import audit_step_transfers
    from coslam_torch.slam.state import TrackTable
    C = step8["C"]
    names = [f"tracks.{n}" for n in TrackTable._fields]
    want = {**{("to_shard", n): C for n in names},
            **{("to_main", n): C for n in names},
            ("to_main", "ncc.blocks"): C, ("to_main", "ncc.ok"): C}
    assert step8["census"] == want
    assert sum(want.values()) == C * (2 * len(names) + 2)
    assert audit_step_transfers(8, devices=["cpu"] * 8) == want


# ------------------------------------------------------ distributed BA ----

def _list_problem(rng):
    """tests/test_parallel.py::_make_prob's problem (4 cameras, 128
    points, the observations padded to a multiple of 8)."""
    from coslam_tpu.geometry import se3
    n_cams, n_pts, n_dev = 4, 128, 8
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
    X = rng.uniform(-3, 3, (n_pts, 3)).astype(np.float32)
    X[:, 2] += 9
    Rs, ts = [], []
    for m in range(n_cams):
        w = 0.05 * rng.standard_normal(3).astype(np.float32)
        Rs.append(np.asarray(se3.so3_exp(jnp.asarray(w))))
        ts.append(np.array([0.5 * m, 0.05 * m, 0.0], np.float32))
    Rs, ts = np.stack(Rs), np.stack(ts)
    oc = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    op = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", Rs[oc], X[op]) + ts[oc]
    px = (Xc[:, :2] / Xc[:, 2:3] * 300 + [160, 120]).astype(np.float32)
    px += 0.3 * rng.standard_normal(px.shape).astype(np.float32)
    O = len(oc)
    pad = (-O) % n_dev

    def padded(a, fill=0):
        return np.concatenate([a, np.full((pad,) + a.shape[1:], fill,
                                          a.dtype)])
    valid = np.concatenate([np.ones(O, bool), np.zeros(pad, bool)])
    cam_fixed = np.zeros(n_cams, bool)
    cam_fixed[:2] = True
    Rs_p = Rs.copy()
    for m in range(2, n_cams):
        dR = np.asarray(se3.so3_exp(jnp.asarray(
            0.02 * rng.standard_normal(3).astype(np.float32))))
        Rs_p[m] = dR @ Rs[m]
    return dict(K=np.broadcast_to(K, (n_cams, 3, 3)).copy(), R=Rs_p, t=ts,
                X=X + 0.05, obs_cam=padded(oc), obs_pt=padded(op),
                obs_px=padded(px), obs_valid=valid, cam_fixed=cam_fixed,
                point_fixed=np.zeros(n_pts, bool))


def _table_problem(rng):
    """tests/test_parallel.py::test_dist_table_ba_matches_single_device's
    problem (6 slots, 128 points; points seen once frozen)."""
    from coslam_tpu.geometry import se3
    S, Ppts = 6, 128
    K1 = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
    X = rng.uniform(-3, 3, (Ppts, 3)).astype(np.float32)
    X[:, 2] += 9
    Rs, ts = [], []
    for m in range(S):
        w = 0.05 * rng.standard_normal(3).astype(np.float32)
        Rs.append(np.asarray(se3.so3_exp(jnp.asarray(w))))
        ts.append(np.array([0.4 * m, 0.05 * m, 0.0], np.float32))
    Rs, ts = np.stack(Rs), np.stack(ts)
    valid = rng.random((S, Ppts)) > 0.4
    px = np.zeros((S, 2, Ppts), np.float32)
    for s in range(S):
        Xc = X @ Rs[s].T + ts[s]
        px[s, 0] = Xc[:, 0] / Xc[:, 2] * 300 + 160
        px[s, 1] = Xc[:, 1] / Xc[:, 2] * 300 + 120
    px += 0.3 * rng.standard_normal(px.shape).astype(np.float32)
    cam_fixed = np.zeros(S, bool)
    cam_fixed[:2] = True
    Rp = Rs.copy()
    for m in range(2, S):
        dR = np.asarray(se3.so3_exp(jnp.asarray(
            0.02 * rng.standard_normal(3).astype(np.float32))))
        Rp[m] = dR @ Rs[m]
    return dict(K=np.broadcast_to(K1[None], (S, 3, 3)).copy(), R=Rp, t=ts,
                X=X + 0.05, obs_px=px, obs_valid=valid, cam_fixed=cam_fixed,
                point_fixed=valid.sum(0) < 2)


def _assert_ba_close(got, want, x_mask=None):
    np.testing.assert_allclose(tp.n(got.R), np.asarray(want.R), atol=5e-4)
    np.testing.assert_allclose(tp.n(got.t), np.asarray(want.t), atol=5e-4)
    gx, wx = tp.n(got.X), np.asarray(want.X)
    if x_mask is not None:
        gx, wx = gx[x_mask], wx[x_mask]
    np.testing.assert_allclose(gx, wx, atol=5e-3)


@pytest.mark.parametrize("form", ["list", "table"])
def test_dist_ba_against_single_device_and_jax(rng, form):
    """The port's distributed BA over 8 shards of ["cpu"] * 8 against its
    single-device solve and against the JAX package's distributed solve
    over 8 devices, on the problems of tests/test_parallel.py, with that
    file's settings (list: max_err 10, 10 inner iterations; table:
    max_err 6, 12)."""
    from coslam_torch.parallel.dist_ba import (dist_bundle_adjust,
                                               dist_bundle_adjust_table)
    from coslam_torch.parallel.mesh import make_cam_mesh
    from coslam_torch.solvers import ba as tba
    from coslam_tpu.parallel import dist_ba as jdist
    from coslam_tpu.parallel.mesh import make_cam_mesh as jmesh
    from coslam_tpu.solvers import ba as jba
    mesh = make_cam_mesh(devices=["cpu"] * 8)
    if form == "list":
        arrs = _list_problem(rng)
        kw = dict(max_err=10.0, max_iter=2, inner_iter=10)
        tprob = tba.BAProblem(**{k: tp.t(v) for k, v in arrs.items()})
        jprob = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrs.items()})
        got = dist_bundle_adjust(tprob, mesh, **kw)
        single = tba.bundle_adjust(tprob, **kw)
        ref = jdist.dist_bundle_adjust(jprob, jmesh(8), **kw)
        x_mask = None
        assert float(torch.median(got.obs_err[tprob.obs_valid])) < 1.0
    else:
        arrs = _table_problem(rng)
        kw = dict(max_err=6.0, max_iter=2, inner_iter=12)
        tprob = tba.BATableProblem(**{k: tp.t(v) for k, v in arrs.items()})
        jprob = jba.BATableProblem(**{k: jnp.asarray(v)
                                      for k, v in arrs.items()})
        got = dist_bundle_adjust_table(tprob, mesh, **kw)
        single = tba.bundle_adjust_table(tprob, **kw)
        ref = jdist.dist_bundle_adjust_table(jprob, jmesh(8), **kw)
        x_mask = ~arrs["point_fixed"]
        assert tuple(got.obs_err.shape) == tuple(arrs["obs_valid"].shape)
    _assert_ba_close(got, single, x_mask)
    _assert_ba_close(got, ref, x_mask)
    assert abs(float(got.cost) - float(single.cost)) <= \
        1e-4 * float(single.cost)
    assert tuple(got.obs_err.shape) == tuple(single.obs_err.shape)
    both = tp.n(tprob.obs_valid)
    assert (tp.n(got.obs_outlier) != tp.n(single.obs_outlier))[both].sum() \
        <= 2


def test_dist_ba_requires_divisible_axes(rng):
    from coslam_torch.parallel.dist_ba import (dist_bundle_adjust,
                                               dist_bundle_adjust_table)
    from coslam_torch.parallel.mesh import make_cam_mesh
    from coslam_torch.solvers import ba as tba
    mesh = make_cam_mesh(devices=["cpu"] * 3)
    arrs = _list_problem(rng)                 # 512 observations, 128 points
    with pytest.raises(ValueError, match="observations"):
        dist_bundle_adjust(tba.BAProblem(
            **{k: tp.t(v) for k, v in arrs.items()}), mesh)
    arrs = _table_problem(rng)
    with pytest.raises(ValueError, match="points"):
        dist_bundle_adjust_table(tba.BATableProblem(
            **{k: tp.t(v) for k, v in arrs.items()}), mesh)


# ------------------------------------------------ harness and the mesh ----

def test_dryrun_8_devices():
    from coslam_torch.parallel.dryrun import run_dryrun
    out = run_dryrun(8, verbose=False, devices=["cpu"] * 8)
    assert len(out["n_tracked"]) == 8 and min(out["n_tracked"]) > 0
    assert out["list_median_err"] < 1.0


def test_step_scaling_harness_runs():
    """tests/test_scaling_harness.py's check of the harness on sub-meshes."""
    from coslam_torch.parallel.scaling import step_scaling
    rows = step_scaling(device_counts=(1, 2), n_cams=2, iters=2,
                        devices=["cpu"] * 2)
    assert [r["n_devices"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["step_ms"]) and r["step_ms"] > 0
               for r in rows)
    assert rows[0]["efficiency"] == 1.0


def test_make_cam_mesh(monkeypatch):
    """Too few cards raise (no CPU fallback); explicit devices are taken as
    given, repeats included; a camera count the mesh does not divide
    raises."""
    from coslam_torch.parallel.mesh import make_cam_mesh
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 CUDA devices, have 1"):
        make_cam_mesh(2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="have 0"):
        make_cam_mesh()
    mesh = make_cam_mesh(devices=["cpu"] * 4)
    assert len(mesh) == 4 and mesh.main == torch.device("cpu")
    assert make_cam_mesh(3, devices=["cpu"] * 4).devices == \
        [torch.device("cpu")] * 3
    assert mesh.blocks(8) == [slice(0, 2), slice(2, 4), slice(4, 6),
                              slice(6, 8)]
    with pytest.raises(ValueError, match="divide"):
        mesh.blocks(6)
    with pytest.raises(ValueError, match="divide"):
        mesh.scatter(torch.zeros(6, 3), "x")


def test_engine_checks_its_mesh():
    """The engine takes one device a camera and runs on the mesh's first
    device."""
    from coslam_torch.config import small_test_config
    from coslam_torch.parallel.mesh import make_cam_mesh
    from coslam_torch.slam.pipeline import CoSlamEngine
    K, kc = tp.kmats(2)
    cfg = small_test_config(2, 96, 128)
    eng = CoSlamEngine(cfg, K, kc, mesh=make_cam_mesh(devices=["cpu"] * 2))
    assert eng.device == torch.device("cpu")
    with pytest.raises(ValueError, match="one a camera"):
        CoSlamEngine(cfg, K, kc, mesh=make_cam_mesh(devices=["cpu"]))
    with pytest.raises(ValueError, match="first device"):
        CoSlamEngine(cfg, K, kc, device="cpu",
                     mesh=make_cam_mesh(devices=["meta", "cpu"]))
