"""The tracking front end as the kernels see it, on the CPU: the plain
twins of ``csrc/klt_track.cu`` and ``csrc/build_pyramid.cu`` against the
JAX package, at the shapes where the kernels' indexing could slip.

- KLT with two cameras: cameras ride the flattened feature axis (the
  kernel's camera is ``feature // N``), four levels of which the level
  filter drops the coarsest. Bands of
  tests/test_torch_ops.py::test_klt_tracked_positions: positions to 1e-3
  px, gain to 1e-4, SSD to rtol 1e-3 / atol 1e-2, at most one feature
  per camera whose validity flips at a threshold.
- The pyramid: the plain composition (per-level filters, 2x2 average
  between levels) against JAX ``build_pyramid`` to 1e-3 (the bound of
  tests/test_pyramid_pallas.py; in practice float32 rounding).
- The per-feature early exit of the kernel rests on finished features
  never changing in the plain loop: checked here bit for bit.
- On the CPU no kernel launches, through the engine's whole path."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import torch_parity as tp

K1_TOL = 1e-3


@pytest.mark.parametrize("with_gain", [True, False])
def test_klt_two_cameras_matches_jax(rng, with_gain):
    from coslam_tpu.config import KLTConfig as JK
    from coslam_tpu.ops import build_pyramid as jbp
    from coslam_tpu.ops import klt_track as jklt
    from coslam_torch.config import KLTConfig as TK
    from coslam_torch.ops.klt import _kept_levels, klt_track_plain
    # without the gain model a brightness change fails the SSD threshold
    imgs0, imgs1, pos, valid = tp.klt_two_camera_case(
        rng, 0.85 if with_gain else 1.0)
    p0, p1 = jbp(jnp.asarray(imgs0), 4), jbp(jnp.asarray(imgs1), 4)
    t0, t1 = tp.pyramid_to_torch(p0), tp.pyramid_to_torch(p1)
    tcfg = TK(n_levels=4, track_with_gain=with_gain)
    assert _kept_levels(t1, tcfg) == [2, 1, 0]      # 15x20 is dropped
    jr = jklt(p0, p1, jnp.asarray(pos), jnp.asarray(valid),
              JK(n_levels=4, track_with_gain=with_gain))
    tr = klt_track_plain(t0, t1, tp.t(pos), tp.t(valid), tcfg)
    jv, tv = np.asarray(jr.valid), tp.n(tr.valid)
    for c in range(2):
        assert jv[c].sum() > 0.6 * jv[c].size
        assert (jv[c] != tv[c]).sum() <= 1
    assert not jv[1, 5] and not tv[1, 5]
    both = jv & tv
    np.testing.assert_allclose(tp.n(tr.pos)[both], np.asarray(jr.pos)[both],
                               atol=1e-3)
    np.testing.assert_allclose(tp.n(tr.gain)[both],
                               np.asarray(jr.gain)[both], atol=1e-4)
    np.testing.assert_allclose(tp.n(tr.ssd)[both], np.asarray(jr.ssd)[both],
                               rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 120, 160)])
def test_build_pyramid_plain_matches_jax(rng, shape):
    from coslam_tpu.ops import build_pyramid as jbp
    from coslam_torch.ops.pyramid import build_pyramid_plain
    img = rng.uniform(0, 255, shape).astype(np.float32)
    a = jbp(jnp.asarray(img), 4, impl="xla")
    b = build_pyramid_plain(tp.t(img), 4)
    assert [tuple(x.shape) for x in b.imgs] == \
        [(shape[0], shape[1] >> lv, shape[2] >> lv) for lv in range(4)]
    for x, y in zip(a.imgs + a.dxs + a.dys, b.imgs + b.dxs + b.dys):
        assert x.shape == tuple(y.shape)
        assert np.abs(tp.n(y) - np.asarray(x)).max() <= K1_TOL


def test_done_features_stay_put(rng):
    """One level of the plain loop cut to k iterations leaves every
    feature that finished within k iterations exactly as the full run
    does: what makes the kernel's per-feature exit give the plain
    result."""
    from coslam_torch.config import KLTConfig
    from coslam_torch.ops.klt import _track_level
    from coslam_torch.ops.pyramid import build_pyramid_plain
    imgs0, imgs1, pos, valid = tp.klt_two_camera_case(rng)
    p0 = build_pyramid_plain(tp.t(imgs0), 1)
    p1 = build_pyramid_plain(tp.t(imgs1), 1)
    pos_f = tp.t(pos).reshape(-1, 2)
    g = torch.ones(pos_f.shape[0])
    full = _track_level(p0.imgs[0], p1.imgs[0], pos_f, pos_f, g,
                        KLTConfig())
    its = full[-1]
    assert int(its.min()) >= 1 and int(its.max()) <= 12
    for k in (4, 6):
        cut = _track_level(p0.imgs[0], p1.imgs[0], pos_f, pos_f, g,
                           KLTConfig(n_iterations=k))
        same = its < k
        assert 0 < int(same.sum()) < same.numel()
        assert torch.equal(cut[-1][same], its[same])
        for a, b in zip(full, cut):
            assert torch.equal(a[same], b[same])


def test_cpu_path_launches_no_kernel():
    """Twelve frames of the engine on the CPU (bootstrap and tracked
    frames, through build_pyramid, klt_track and the NCC windows): every
    launch counter stays where it was."""
    from coslam_torch.config import small_test_config
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence)
    from coslam_torch.ops.klt import klt_track
    from coslam_torch.ops.patches import extract_windows
    from coslam_torch.ops.pyramid import build_pyramid
    from coslam_torch.slam.pipeline import CoSlamEngine
    Rs, ts = orbit_trajectory(12, forward=0.06)
    frames = render_sequence(make_room(np.random.default_rng(0), size=10.0),
                             tp.KMAT[0], Rs, ts, tp.H, tp.W, device="cpu")
    counters = (build_pyramid, klt_track, extract_windows)
    n0 = [f.launches for f in counters]
    eng = CoSlamEngine(small_test_config(1, tp.H, tp.W), tp.KMAT, tp.KC,
                       device="cpu")
    for f in range(12):
        eng.process_frame(frames[f][None])
    assert eng.bootstrapped
    assert [f.launches for f in counters] == n0 == [0, 0, 0]
