"""The port's engine on a camera mesh against its single-device engine in
the engine modes: overlap, async BA and non-fused (split from
tests/test_torch_mesh_engine.py, which makes the same comparison in the
default mode). Two cameras on the rig of tests/test_pipeline_multicam.py
at 150x200 (frames rendered by the JAX package, tests/torch_parity.py),
the mesh ``["cpu"] * 2``, one camera a shard: the same keyframes and
groups, the trajectories within the JAX test's 0.05, each camera's pose
within 1e-5 (on the CPU a shard runs the single-device step's arithmetic
on its camera).
"""

import pytest

import torch_parity as tp

C = 2


@pytest.fixture(scope="module")
def frames20():
    frames, Rs, ts = tp.render_rig_frames(C, 20)
    return frames, Rs, ts


@pytest.mark.parametrize("mode", [dict(overlap=True), dict(async_ba=True),
                                  dict(use_fused=False)],
                         ids=["overlap", "async_ba", "non_fused"])
def test_modes_on_a_mesh_match_single_device(frames20, mode):
    frames, _, _ = frames20
    one = tp.port_test_engine(C, **mode)
    mesh = tp.port_test_engine(C, tp.cpu_mesh(C), **mode)
    tp.assert_same_run(one, mesh, tp.run_frames(one, frames),
                       tp.run_frames(mesh, frames))
    if mode.get("async_ba"):
        assert mesh.ba_async["dispatched"] >= 1
        assert mesh.ba_async == one.ba_async
