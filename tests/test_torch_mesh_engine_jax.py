"""The port's engine on a camera mesh against the JAX package's mesh
engine and the bands of tests/test_mesh_engine.py (split from
tests/test_torch_mesh_engine.py and _modes.py, which hold the mesh engine
against the port's single-device engine): two cameras on the rig of
tests/test_pipeline_multicam.py at 150x200 (frames rendered by the JAX
package, tests/torch_parity.py), the mesh ``["cpu"] * 2``, one camera a
shard.

- The chunk=3 mesh engine over 30 frames: bootstraps, one group, every
  camera's ATE under 0.25 (tests/test_mesh_engine.py's band).
- The slice as a whole: the port's mesh engine against the JAX package's
  mesh engine (its 2-device virtual CPU mesh) on the same frames, the
  port taking over the JAX bootstrap (``run_port_engine(handover=)``), in
  the engine-mode bands of tests/torch_parity.py.
"""

import numpy as np

import torch_parity as tp

C = 2


def test_chunked_engine_on_a_mesh():
    """tests/test_mesh_engine.py::test_engine_on_two_device_mesh: the
    chunk=3 mesh engine over 30 frames bootstraps, stays one group and
    every camera's ATE is under 0.25."""
    from coslam_torch.io.ate import ate_rmse
    frames, Rs, ts = tp.render_rig_frames(C, 30)
    eng = tp.port_test_engine(C, tp.cpu_mesh(C), chunk=3)
    for f in frames:
        eng.process_frame(f)
    eng._flush_chunk()
    assert eng.bootstrapped
    assert (eng.group_id == eng.group_id[0]).all()
    for c in range(C):
        ate = ate_rmse(*eng.trajectory(c, True), Rs[c], ts[c])
        assert ate < 0.25, (c, ate)


def test_mesh_engine_against_the_jax_mesh_engine():
    """Both packages' mesh engines on the same 20 frames: the same
    bootstrap frame and logged frames, keyframes within the band of
    tests/torch_parity.py, every ATE under 0.25, the camera centres within
    5% of the path (RMS after Sim(3) alignment)."""
    import jax
    from jax.sharding import Mesh
    frames, Rs, ts = tp.render_rig_frames(C, 20)
    ref = tp.run_jax_engine(frames, mesh=Mesh(np.array(jax.devices()[:C]),
                                              ("cam",)))
    port = tp.run_port_engine(frames, handover=ref["boot"],
                              mesh=tp.cpu_mesh(C))
    tp.check_bootstrap_and_logged_frames(ref, port, frames.shape[0])
    tp.check_keyframes(ref, port)
    tp.check_ate(ref, port, Rs, ts, 0.25)
    tp.check_centres(ref, port, C)
    assert port["engine"].mesh is not None
    assert port["engine"].mesh.census[("to_main", "ncc.blocks")] > 0
