"""The port's engine on a camera mesh (the counterpart of
tests/test_mesh_engine.py): two cameras on the rig of
tests/test_pipeline_multicam.py at 150x200 (frames rendered by the JAX
package, tests/torch_parity.py), the mesh ``["cpu"] * 2``, one camera a
shard.

- The mesh engine against the port's single-device engine, in the
  default mode and in overlap, async BA and non-fused: the same keyframes
  and groups, the trajectories within the JAX test's 0.05 (each camera's
  pose within 1e-5 too: a shard runs the single-device step's arithmetic
  on its camera, so on the CPU they agree exactly).
- The chunk=3 mesh engine over 30 frames: bootstraps, one group, every
  camera's ATE under 0.25 (tests/test_mesh_engine.py's band).
- The slice as a whole: the port's mesh engine against the JAX package's
  mesh engine (its 2-device virtual CPU mesh) on the same frames, the
  port taking over the JAX bootstrap (``run_port_engine(handover=)``), in
  the engine-mode bands of tests/torch_parity.py.
- A checkpoint of a mesh engine loads into a single-device engine and a
  single-device engine's into a mesh engine: each pair then runs on
  identically.
"""

import numpy as np
import pytest

import torch_parity as tp

C = 2


def _mesh():
    from coslam_torch.parallel.mesh import make_cam_mesh
    return make_cam_mesh(devices=["cpu"] * C)


def _engine(mesh=None, **kw):
    from coslam_torch.config import small_test_config
    from coslam_torch.slam.pipeline import CoSlamEngine
    return CoSlamEngine(small_test_config(C, tp.H, tp.W), *tp.kmats(C),
                        device="cpu", mesh=mesh, **kw)


def _run(eng, frames):
    for f in frames:
        eng.process_frame(f)
    return [eng.trajectory(c, correct=False) for c in range(C)]


def _centres(traj):
    R, t = traj
    return -np.einsum("fji,fj->fi", R, t)


def _assert_same_run(a, b, ta, tb):
    assert a.bootstrapped and b.bootstrapped
    assert a.kf_frames == b.kf_frames, (a.kf_frames, b.kf_frames)
    assert a.group_hist == b.group_hist
    for c in range(C):
        gap = float(np.abs(_centres(ta[c]) - _centres(tb[c])).max())
        assert gap < 0.05, (c, gap)
        for x, y in zip(ta[c], tb[c]):
            np.testing.assert_allclose(x, y, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def frames20():
    frames, Rs, ts = tp.render_rig_frames(C, 20)
    return frames, Rs, ts


def test_mesh_engine_matches_single_device_keyframes():
    """tests/test_mesh_engine.py's check, 18 frames of the rig: the
    sharding is a layout, not an algorithm change."""
    frames, _, _ = tp.render_rig_frames(C, 18)
    one, mesh = _engine(), _engine(_mesh())
    _assert_same_run(one, mesh, _run(one, frames), _run(mesh, frames))
    assert len(one.kf_frames) >= 3


@pytest.mark.parametrize("mode", [dict(overlap=True), dict(async_ba=True),
                                  dict(use_fused=False)],
                         ids=["overlap", "async_ba", "non_fused"])
def test_modes_on_a_mesh_match_single_device(frames20, mode):
    frames, _, _ = frames20
    one, mesh = _engine(**mode), _engine(_mesh(), **mode)
    _assert_same_run(one, mesh, _run(one, frames), _run(mesh, frames))
    if mode.get("async_ba"):
        assert mesh.ba_async["dispatched"] >= 1
        assert mesh.ba_async == one.ba_async


def test_chunked_engine_on_a_mesh():
    """tests/test_mesh_engine.py::test_engine_on_two_device_mesh: the
    chunk=3 mesh engine over 30 frames bootstraps, stays one group and
    every camera's ATE is under 0.25."""
    from coslam_torch.io.ate import ate_rmse
    frames, Rs, ts = tp.render_rig_frames(C, 30)
    eng = _engine(_mesh(), chunk=3)
    for f in frames:
        eng.process_frame(f)
    eng._flush_chunk()
    assert eng.bootstrapped
    assert (eng.group_id == eng.group_id[0]).all()
    for c in range(C):
        ate = ate_rmse(*eng.trajectory(c, True), Rs[c], ts[c])
        assert ate < 0.25, (c, ate)


def test_mesh_engine_against_the_jax_mesh_engine(frames20):
    """Both packages' mesh engines on the same 20 frames: the same
    bootstrap frame and logged frames, keyframes within the band of
    tests/torch_parity.py, every ATE under 0.25, the camera centres within
    5% of the path (RMS after Sim(3) alignment)."""
    import jax
    from jax.sharding import Mesh
    frames, Rs, ts = frames20
    ref = tp.run_jax_engine(frames, mesh=Mesh(np.array(jax.devices()[:C]),
                                              ("cam",)))
    port = tp.run_port_engine(frames, handover=ref["boot"], mesh=_mesh())
    tp.check_bootstrap_and_logged_frames(ref, port, frames.shape[0])
    tp.check_keyframes(ref, port)
    tp.check_ate(ref, port, Rs, ts, 0.25)
    tp.check_centres(ref, port, C)
    assert port["engine"].mesh is not None
    assert port["engine"].mesh.census[("to_main", "ncc.blocks")] > 0


def test_checkpoint_between_mesh_and_single_device(frames20, tmp_path):
    """A file saved at frame 10 by a mesh engine and by a single-device
    engine (the same run so far: the files hold the same arrays) loads into
    the other kind of engine, which then runs frames 10-19 as the saver's
    kind does from the same file."""
    from coslam_torch.io.checkpoint import load_checkpoint, save_checkpoint
    frames, _, _ = frames20
    paths = {}
    for kind in ("mesh", "single"):
        eng = _engine(_mesh() if kind == "mesh" else None)
        _run(eng, frames[:10])
        paths[kind] = tmp_path / f"{kind}.npz"
        save_checkpoint(str(paths[kind]), eng)
    a, b = (dict(np.load(paths[k])) for k in ("mesh", "single"))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for saved in ("mesh", "single"):
        runs = []
        for kind in ("mesh", "single"):
            eng = load_checkpoint(str(paths[saved]),
                                  _engine(_mesh() if kind == "mesh" else None))
            assert eng.frame == 10
            runs.append((eng, _run(eng, frames[10:])))
        _assert_same_run(runs[0][0], runs[1][0], runs[0][1], runs[1][1])
