"""The port's chunked mesh step (``slam/fused.py::frame_steps_chunk`` with
``mesh=``) on a CPU mesh, against the JAX package's on two of its eight
virtual CPU devices (tests/conftest.py) and against the port's own
single-device chunk. Split from tests/test_torch_parallel.py (the single
mesh step, the distributed BA and the harness), whose module docstring
gives the bands: three chained steps from the JAX package's seeded table,
in the bands of tests/test_torch_fused_scan.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

import torch_parity as tp

H, W, FEATS = tp.MESH_H, tp.MESH_W, tp.MESH_FEATS


@pytest.fixture(scope="module")
def chunk3():
    """frame_steps_chunk over 3 frames at C = 4 on a 2-device mesh (two
    cameras a shard): JAX's, the port's mesh and single-device runs."""
    from coslam_torch.parallel.mesh import make_cam_mesh
    from coslam_torch.parallel.scaling import mesh_cfg
    from coslam_torch.slam.fused import frame_steps_chunk, shard_frames
    from coslam_tpu.parallel.mesh import shard_state
    from coslam_tpu.slam.fused import frame_steps_chunk as jchunk
    from coslam_tpu.slam.state import SlamState
    from coslam_tpu.ops.pyramid import Pyramid as JPyr
    C, n_dev = 4, 2
    imgs, K, kc = tp.mesh_images(C, seed=1)
    seq = np.stack([np.roll(imgs, i, axis=-1) for i in range(1, 4)])
    jcfg, seeded, pyr0 = tp.jax_seeded(C, imgs, K, kc)
    jmesh = Mesh(np.array(jax.devices()[:n_dev]), ("cam",))
    js = shard_state(jax.tree.map(jnp.asarray, SlamState(*seeded)), jmesh)
    js, _, jflat = jchunk(js, jax.tree.map(jnp.asarray, JPyr(*pyr0)),
                          jnp.asarray(seq), jnp.asarray(K), jnp.asarray(kc),
                          jcfg, mesh=jmesh)
    tcfg = mesh_cfg(C, H, W, FEATS)
    mesh = make_cam_mesh(devices=["cpu"] * n_dev)
    st, pyr, tK, tkc = tp.port_mesh_start(mesh, seeded, pyr0, K, kc)
    per = [shard_frames(mesh, tp.t(f)) for f in seq]
    shards = [torch.stack([p[k] for p in per]) for k in range(n_dev)]
    ts, _, tflat = frame_steps_chunk(st, pyr, shards, tK, tkc, tcfg,
                                     mesh=mesh)
    s1, p1, tK1, tkc1 = tp.port_single_start(seeded, pyr0, K, kc)
    ss, _, sflat = frame_steps_chunk(s1, p1, tp.t(seq), tK1, tkc1, tcfg)
    return dict(jax=(tp.to_numpy(js), np.asarray(jflat)), mesh=(ts, tflat),
                single=(ss, sflat), C=C, D=seeded.kfs.dyn_xyz.shape[1])


def test_mesh_chunk_against_jax_mesh_chunk(chunk3):
    """Three chained steps: the bands of tests/test_torch_fused_scan.py
    (track tables within 1e-2 px and 8 flips, counts within 3, poses to
    2e-3 / 5e-3), the host-scan block equal."""
    from coslam_torch.slam.fused import unpack_stats
    (js, jflat), (ts, tflat) = chunk3["jax"], chunk3["mesh"]
    C, D = chunk3["C"], chunk3["D"]
    tflat = tp.n(tflat)
    assert tflat.shape == jflat.shape
    assert int(ts.frame) == int(js.frame) == 3
    tp.assert_tracks_close(js.tracks, ts.tracks, max_flips=8, pos_tol=1e-2)
    scan_len = C * (3 * C + 2)
    rows, jrows = (v[:-scan_len].reshape(3, -1) for v in (tflat, jflat))
    for i in range(3):
        tu, ju = unpack_stats(rows[i], C, D), unpack_stats(jrows[i], C, D)
        assert np.abs(tu.n_tracked - ju.n_tracked).max() <= 3
        np.testing.assert_allclose(tu.R, ju.R, atol=2e-3)
        np.testing.assert_allclose(tu.t, ju.t, atol=5e-3)
    np.testing.assert_array_equal(tflat[-scan_len:], jflat[-scan_len:])


def test_mesh_chunk_equals_single_device_chunk(chunk3):
    (ts, tflat), (ss, sflat) = chunk3["mesh"], chunk3["single"]
    tp.assert_states_equal(ts, ss)
    np.testing.assert_array_equal(tp.n(tflat), tp.n(sflat))
