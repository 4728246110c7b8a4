"""The chunked core, the deferred BA write-back and the production-depth
triangulation of the port against the JAX package (CPU).

- ``frame_steps_scan`` / ``frame_steps_chunk`` at small_test_config(2)
  over 4 frames (the inputs of tests/test_fused_scan.py): bit-identical to
  sequential ``frame_step`` calls of the port, and within the bands that
  tests/test_torch_engine.py holds ``frame_step`` to against the JAX
  package's ``frame_steps_chunk`` (track tables by
  ``assert_tracks_close``; stats rows' poses to the three-step bands), the
  host-scan block equal.
- ``apply_ba_table_results(..., gen0=)``: the same BA result written back
  by both packages into a state one frame past the dispatch in which some
  slots were re-minted: the same slots skipped, points within 1e-6.
- ``new_map_points`` at the production history depth T = 21 (the
  log-spaced second-view subset; tests/test_new_points_subset.py's scene):
  the same allocations and points within 1e-4 of each other.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_parity as tp


def _scan_inputs(rng):
    from coslam_tpu.config import small_test_config
    from coslam_tpu.ops.image import gaussian_blur
    cfg = small_test_config(num_cameras=2)
    C, H, W = 2, cfg.image_height, cfg.image_width
    imgs = np.asarray(gaussian_blur(jnp.asarray(
        rng.uniform(0, 255, (C, H, W)), jnp.float32)))
    K = np.broadcast_to(np.asarray(
        [[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32),
        (C, 3, 3)).copy()
    seq = np.stack([np.roll(imgs, i, axis=-1) for i in range(1, 5)])
    return imgs, K, np.zeros((C, 5), np.float32), seq


@pytest.fixture(scope="module")
def scan_runs():
    """The port's chunk, scan and sequential steps, and the JAX chunk, from
    the same initial state and images."""
    from coslam_torch.config import small_test_config as tcfg
    from coslam_torch.ops.pyramid import build_pyramid
    from coslam_torch.slam.fused import (frame_step, frame_steps_chunk,
                                         frame_steps_scan, pack_stats)
    from coslam_torch.slam.state import init_state
    from coslam_tpu.config import small_test_config as jcfg
    from coslam_tpu.ops import build_pyramid as jbuild
    from coslam_tpu.slam.fused import frame_steps_chunk as jchunk
    from coslam_tpu.slam.state import init_state as jinit
    imgs, K, kc, seq = _scan_inputs(np.random.default_rng(0))
    jc, tc = jcfg(num_cameras=2), tcfg(num_cameras=2)
    js, jp, jflat = jchunk(jinit(jc), jbuild(jnp.asarray(imgs),
                                             jc.klt.n_levels),
                           jnp.asarray(seq), jnp.asarray(K),
                           jnp.asarray(kc), jc)
    tK, tkc = tp.t(K), tp.t(kc)

    def start():
        return init_state(tc, "cpu"), build_pyramid(tp.t(imgs),
                                                    tc.klt.n_levels)
    s_chunk, _, flat = frame_steps_chunk(*start(), tp.t(seq), tK, tkc, tc)
    s_scan, _, rows = frame_steps_scan(*start(), tp.t(seq), tK, tkc, tc)
    s_seq, pyr = start()
    per_frame = []
    for i in range(seq.shape[0]):
        s_seq, pyr, fs = frame_step(s_seq, pyr, tp.t(seq[i]), tK, tkc, tc)
        per_frame.append(pack_stats(fs))
    return dict(jax=(tp.to_numpy(js), np.asarray(jflat)),
                chunk=(s_chunk, flat), scan=(s_scan, rows),
                seq=(s_seq, torch.stack(per_frame)), C=2)


def test_scan_and_chunk_equal_sequential_steps(scan_runs):
    from coslam_torch.slam.state import state_to_numpy
    s_seq, rows_seq = scan_runs["seq"]
    ref = state_to_numpy(s_seq)
    for key in ("scan", "chunk"):
        st, out = scan_runs[key]
        got = state_to_numpy(st)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b, err_msg=key)
    _, rows = scan_runs["scan"]
    np.testing.assert_array_equal(tp.n(rows), tp.n(rows_seq))
    _, flat = scan_runs["chunk"]
    S = rows.shape[1]
    np.testing.assert_array_equal(tp.n(flat)[:4 * S], tp.n(rows).reshape(-1))


def test_chunk_against_jax(scan_runs):
    from coslam_torch.slam.fused import unpack_stats
    js, jflat = scan_runs["jax"]
    ts_, flat = scan_runs["chunk"]
    C = scan_runs["C"]
    flat = tp.n(flat)
    assert flat.shape == jflat.shape
    assert int(ts_.frame) == int(js.frame) == 4
    tp.assert_tracks_close(js.tracks, ts_.tracks, max_flips=8, pos_tol=1e-2)
    scan_len = C * (3 * C + 2)
    D = js.kfs.dyn_xyz.shape[1]
    rows, jrows = (v[:-scan_len].reshape(4, -1) for v in (flat, jflat))
    for i in range(4):
        tu, ju = unpack_stats(rows[i], C, D), unpack_stats(jrows[i], C, D)
        assert np.abs(tu.n_tracked - ju.n_tracked).max() <= 3
        np.testing.assert_allclose(tu.R, ju.R, atol=2e-3)
        np.testing.assert_allclose(tu.t, ju.t, atol=5e-3)
    np.testing.assert_array_equal(flat[-scan_len:], jflat[-scan_len:])


def test_ba_write_back_with_gen0():
    """A BA dispatched at snapshot 27's keyframe and written back one
    frame later into a state whose slots 0..9 were re-minted meanwhile
    (generation bumped, a new position): both packages skip exactly those
    slots and agree on the rest."""
    from coslam_tpu.config import small_test_config as jcfg
    from coslam_tpu.slam import steps as js
    from coslam_tpu.slam.fused import frame_step as jstep
    from coslam_tpu.solvers.ba import bundle_adjust_table as jba
    from coslam_torch.config import small_test_config as tcfg
    from coslam_torch.slam import steps as ts_
    from coslam_torch.slam.state import state_from_numpy
    frames, _, _ = tp.render_mono_frames(29)
    run = tp.run_jax_engine(frames, snapshots=(27,))
    st, pyr = run["snaps"][27]
    jc, tc = jcfg(1, tp.H, tp.W), tcfg(1, tp.H, tp.W)
    jK, jkc = jnp.asarray(tp.KMAT), jnp.asarray(tp.KC)
    s0 = jax.tree.map(jnp.asarray, st)
    s0 = s0._replace(kfs=js.add_keyframe(s0))
    gen0 = np.array(s0.mappts.gen)
    prob, ring, kf_ok = js.build_ba_table(s0, jK, jc)
    p = jc.p
    res = tp.to_numpy(jba(prob, max_err=p.max_err, max_iter=p.ba_max_iter,
                          inner_iter=p.ba_inner_iter))
    s1, _, _ = jstep(s0, jax.tree.map(jnp.asarray, pyr),
                     jnp.asarray(frames[28][None]), jK, jkc, jc)
    s1 = tp.to_numpy(s1)
    remint = np.arange(10)
    s1.mappts.gen[remint] += 1
    s1.mappts.xyz[remint] = [5.0, -3.0, 7.0]
    ring, kf_ok = np.asarray(ring), np.asarray(kf_ok)
    jnew = js.apply_ba_table_results(
        jax.tree.map(jnp.asarray, s1), jax.tree.map(jnp.asarray, res),
        jnp.asarray(ring), jnp.asarray(kf_ok), jc, gen0=jnp.asarray(gen0))
    tnew = ts_.apply_ba_table_results(
        state_from_numpy(s1, "cpu"), state_from_numpy(res, "cpu"),
        tp.t(ring).long(), tp.t(kf_ok), tc, gen0=tp.t(gen0))
    same = s1.mappts.gen == gen0
    assert (~same).sum() >= 10 and not same[remint].any()
    jxyz, txyz = np.asarray(jnew.mappts.xyz), tp.n(tnew.mappts.xyz)
    np.testing.assert_array_equal(txyz[~same], s1.mappts.xyz[~same])
    np.testing.assert_array_equal(jxyz[~same], s1.mappts.xyz[~same])
    moved = same & np.any(res.X[:len(same)] != s1.mappts.xyz, axis=1)
    assert moved.sum() > 20
    np.testing.assert_allclose(txyz, jxyz, atol=1e-6)
    np.testing.assert_array_equal(tp.n(tnew.mappts.status),
                                  np.asarray(jnew.mappts.status))
    np.testing.assert_allclose(tp.n(tnew.R), np.asarray(jnew.R), atol=1e-5)
    np.testing.assert_allclose(tp.n(tnew.kfs.t), np.asarray(jnew.kfs.t),
                               atol=1e-5)


def test_new_map_points_at_production_depth(rng):
    """tests/test_new_points_subset.py's scene (a camera moving sideways
    over 21 frames of known points, T = 21: the log-spaced second-view
    subset) through both packages' new_map_points on the same state and
    blocks."""
    from coslam_tpu.config import CapacityConfig, SlamConfig
    from coslam_tpu.slam import steps as js
    from coslam_tpu.slam.state import history_len, init_state
    from coslam_torch.config import CapacityConfig as TCap
    from coslam_torch.config import SlamConfig as TCfg
    from coslam_torch.slam import steps as ts_
    from coslam_torch.slam.state import state_from_numpy
    cap = dict(max_features=128, max_map_points=512, max_keyframes=8)
    jc = SlamConfig(num_cameras=1, image_height=480, image_width=640,
                    cap=CapacityConfig(**cap))
    tc = TCfg(num_cameras=1, image_height=480, image_width=640,
              cap=TCap(**cap))
    T = history_len(jc)
    assert T == 21 and ts_._history_offsets(T).size < T - 1
    N = 128
    X_gt = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                     rng.uniform(4.0, 8.0, N)], axis=1).astype(np.float32)

    def project(f):
        Xc = X_gt + np.array([-0.03 * f, 0, 0], np.float32)
        return (Xc[:, :2] / Xc[:, 2:]) * 500.0 + np.array([320, 240])

    cur = 30
    hist = np.zeros((1, T, N, 2), np.float32)
    ph_R = np.zeros((1, T, 3, 3), np.float32)
    ph_t = np.zeros((1, T, 3), np.float32)
    for k in range(T):
        f = cur - k
        hist[0, f % T] = project(f)
        ph_R[0, f % T] = np.eye(3)
        ph_t[0, f % T] = [-0.03 * f, 0, 0]
    st = tp.to_numpy(init_state(jc))
    st = st._replace(
        frame=np.asarray(cur, np.int32),
        R=np.eye(3, dtype=np.float32)[None],
        t=np.array([[-0.03 * cur, 0, 0]], np.float32),
        tracks=st.tracks._replace(
            pos=hist[:, cur % T].copy(), raw=hist[:, cur % T].copy(),
            valid=np.ones((1, N), bool), age=np.full((1, N), T, np.int32),
            hist=hist, hist_valid=np.ones((1, T, N), bool)),
        pose_hist_R=ph_R, pose_hist_t=ph_t)
    B = (2 * jc.p.ncc_patch_radius + 1) ** 2
    blocks = (np.zeros((1, N, B), np.float32), np.ones((1, N), bool))
    K = np.array([[[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]]],
                 np.float32)
    kc = np.zeros((1, 5), np.float32)
    jm, jt, jn = js.new_map_points(
        jax.tree.map(jnp.asarray, st), None, jnp.asarray(K),
        jnp.asarray(kc), jc, blocks=tuple(map(jnp.asarray, blocks)))
    tm, tt, tn = ts_.new_map_points(
        state_from_numpy(st, "cpu"), None, tp.t(K), tp.t(kc), tc,
        blocks=tuple(map(tp.t, blocks)))
    assert int(tn) == int(jn) >= 0.9 * N
    np.testing.assert_array_equal(tp.n(tt.mpt), np.asarray(jt.mpt))
    np.testing.assert_array_equal(tp.n(tm.status), np.asarray(jm.status))
    np.testing.assert_array_equal(tp.n(tm.gen), np.asarray(jm.gen))
    np.testing.assert_allclose(tp.n(tm.xyz), np.asarray(jm.xyz), atol=1e-4)
    mpt = tp.n(tt.mpt)[0]
    err = np.linalg.norm(tp.n(tm.xyz)[mpt[mpt >= 0]] - X_gt[mpt >= 0],
                         axis=1)
    assert float(np.median(err)) < 0.02
