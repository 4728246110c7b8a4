"""The port's engine on a camera mesh (the counterpart of
tests/test_mesh_engine.py): two cameras on the rig of
tests/test_pipeline_multicam.py at 150x200 (frames rendered by the JAX
package, tests/torch_parity.py), the mesh ``["cpu"] * 2``, one camera a
shard.

- The mesh engine against the port's single-device engine in the
  default mode: the same keyframes and groups, the trajectories within
  the JAX test's 0.05 (each camera's pose within 1e-5 too: a shard runs
  the single-device step's arithmetic on its camera, so on the CPU they
  agree exactly).
- A checkpoint of a mesh engine loads into a single-device engine and a
  single-device engine's into a mesh engine: each pair then runs on
  identically.

The same comparison in overlap, async BA and non-fused mode is in
tests/test_torch_mesh_engine_modes.py; the runs against the JAX mesh
engine and the reference test's bands are in
tests/test_torch_mesh_engine_jax.py.
"""

import numpy as np
import pytest

import torch_parity as tp

C = 2


@pytest.fixture(scope="module")
def frames20():
    frames, Rs, ts = tp.render_rig_frames(C, 20)
    return frames, Rs, ts


def test_mesh_engine_matches_single_device_keyframes():
    """tests/test_mesh_engine.py's check, 18 frames of the rig: the
    sharding is a layout, not an algorithm change."""
    frames, _, _ = tp.render_rig_frames(C, 18)
    one, mesh = tp.port_test_engine(C), tp.port_test_engine(C, tp.cpu_mesh(C))
    tp.assert_same_run(one, mesh, tp.run_frames(one, frames),
                       tp.run_frames(mesh, frames))
    assert len(one.kf_frames) >= 3


def test_checkpoint_between_mesh_and_single_device(frames20, tmp_path):
    """A file saved at frame 10 by a mesh engine and by a single-device
    engine (the same run so far: the files hold the same arrays) loads into
    the other kind of engine, which then runs frames 10-19 as the saver's
    kind does from the same file."""
    from coslam_torch.io.checkpoint import load_checkpoint, save_checkpoint
    frames, _, _ = frames20
    paths = {}
    for kind in ("mesh", "single"):
        eng = tp.port_test_engine(C, tp.cpu_mesh(C) if kind == "mesh"
                                  else None)
        tp.run_frames(eng, frames[:10])
        paths[kind] = tmp_path / f"{kind}.npz"
        save_checkpoint(str(paths[kind]), eng)
    a, b = (dict(np.load(paths[k])) for k in ("mesh", "single"))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for saved in ("mesh", "single"):
        runs = []
        for kind in ("mesh", "single"):
            eng = load_checkpoint(str(paths[saved]), tp.port_test_engine(
                C, tp.cpu_mesh(C) if kind == "mesh" else None))
            assert eng.frame == 10
            runs.append((eng, tp.run_frames(eng, frames[10:])))
        tp.assert_same_run(runs[0][0], runs[1][0], runs[0][1], runs[1][1])
