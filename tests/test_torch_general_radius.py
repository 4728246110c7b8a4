"""The port at the radii that send its kernels down their general paths
(KLT window radius and NCC patch radius 9, above the tuned kernels' 7;
search radius 24, above 20), against the JAX package on the CPU, where
every wrapper takes its plain version:

- the modules: ``klt_track_plain`` at window radius 9 against the JAX
  ``klt_track`` on the same pyramids, in the bands of
  tests/test_torch_klt.py::test_klt_two_cameras_matches_jax (positions to
  1e-3 px, gain to 1e-4, SSD to rtol 1e-3 / atol 1e-2, at most one flip
  of validity per camera); ``ncc_search_plain`` at patch radius 9 and
  search radius 24 against the JAX ``ncc_search`` in the bands of
  tests/test_torch_ncc.py (the same best pixel on >= 99% of the centres,
  scores within 1e-4, NCC_INVALID where the window clamps); the NCC
  blocks at radius 9 are a case of
  tests/test_torch_ncc.py::test_ncc_blocks_batched_engine_shape;
- the engine: both engines over the mono room of tests/torch_parity.py
  (40 frames at 150x200, small_test_config) with both radii at 9, the
  port taking over the JAX bootstrap, in the bands of the engine-mode
  tests (the same bootstrap frame and logged frames, keyframes at most
  two entries apart, ATE under 0.20, camera centres within 5% of the
  path);
- the launch counts: CPU calls at these radii count no launch, general
  or not."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import torch_parity as tp

RADIUS = 9           # window and patch radius, above the tuned paths' 7
SEARCH = 24          # search radius, above the tuned path's 20
F = 40


def radius9(cfg):
    """A config of either package with the KLT window radius and the NCC
    patch radius at RADIUS."""
    return cfg.replace(
        klt=dataclasses.replace(cfg.klt, window_radius=RADIUS),
        p=dataclasses.replace(cfg.p, ncc_patch_radius=RADIUS))


@pytest.mark.parametrize("with_gain", [True, False])
def test_klt_two_cameras_matches_jax_at_radius_9(rng, with_gain):
    from coslam_tpu.config import KLTConfig as JK
    from coslam_tpu.ops import build_pyramid as jbp
    from coslam_tpu.ops import klt_track as jklt
    from coslam_torch.config import KLTConfig as TK
    from coslam_torch.ops.klt import _kept_levels, klt_track_plain
    imgs0, imgs1, pos, valid = tp.klt_two_camera_case(
        rng, 0.85 if with_gain else 1.0)
    p0, p1 = jbp(jnp.asarray(imgs0), 4), jbp(jnp.asarray(imgs1), 4)
    t0, t1 = tp.pyramid_to_torch(p0), tp.pyramid_to_torch(p1)
    tcfg = TK(n_levels=4, track_with_gain=with_gain, window_radius=RADIUS)
    assert _kept_levels(t1, tcfg) == [1, 0]     # 15x20 and 30x40 dropped
    jr = jklt(p0, p1, jnp.asarray(pos), jnp.asarray(valid),
              JK(n_levels=4, track_with_gain=with_gain,
                 window_radius=RADIUS))
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


def test_ncc_search_matches_jax_at_patch_9_search_24(rng):
    """N = 256 on 120x160 (G = 67): centres up to 3 px off the templates'
    true positions, three of them so near the border that their windows
    clamp."""
    from coslam_tpu.ops import ncc as jn
    from coslam_torch.ops import ncc as tn
    # a window clamps where round(centre) - (RADIUS + SEARCH) leaves
    # [0, dim - G - 1]; no centre 3 px or less off a true position does
    G = 2 * (RADIUS + SEARCH) + 1
    lo = RADIUS + SEARCH + 3
    hi = np.array([160.0, 120.0]) - G - 1 + RADIUS + SEARCH - 3
    img = tp.smooth_texture(rng, 120, 160, passes=1)[0]
    true = np.round(rng.uniform(lo, hi, (256, 2))).astype(np.float32)
    centers = true + rng.integers(-3, 4, (256, 2)).astype(np.float32)
    centers[:3] = [[4, 60], [80, 117], [155, 8]]
    blocks, _ = jn.extract_ncc_blocks(jnp.asarray(img), jnp.asarray(true),
                                      RADIUS)
    kw = dict(search_radius=SEARCH, patch_radius=RADIUS)
    jpx, jsc = jn.ncc_search(jnp.asarray(img), jnp.asarray(centers), blocks,
                             **kw)
    tpx, tsc = tn.ncc_search_plain(tp.t(img), tp.t(centers),
                                   tp.t(np.asarray(blocks)), **kw)
    jpx, jsc, tpx, tsc = (np.asarray(jpx), np.asarray(jsc), tp.n(tpx),
                          tp.n(tsc))
    same = (tpx == jpx).all(1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(tsc[same], jsc[same], atol=1e-4)
    np.testing.assert_array_equal(tsc == tn.NCC_INVALID,
                                  jsc == jn.NCC_INVALID)
    assert (jsc[:3] == jn.NCC_INVALID).all() and \
        (jsc[3:] > jn.NCC_INVALID).all()
    assert (np.abs(jpx[3:] - true[3:]).max(1) == 0).mean() > 0.9


def test_cpu_calls_at_radius_9_count_no_launch(rng):
    """klt_track, extract_ncc_blocks_batched and ncc_search on CPU tensors
    at the general radii take their plain versions and leave every count
    of ``launch_counts`` (the general ones too) where it was;
    ``reset_launch_counts`` sets them all to 0."""
    from coslam_torch.config import KLTConfig
    from coslam_torch.ops import (GENERAL_PATHS, kernel_wrappers,
                                  launch_counts, reset_launch_counts)
    from coslam_torch.ops.klt import klt_track, klt_track_plain
    from coslam_torch.ops.ncc import (extract_ncc_blocks_batched,
                                      extract_ncc_blocks_batched_plain,
                                      ncc_search, ncc_search_plain)
    from coslam_torch.ops.pyramid import build_pyramid
    imgs0, imgs1, pos, valid = tp.klt_two_camera_case(rng)
    n0 = launch_counts()
    assert set(n0) == set(kernel_wrappers()) | {
        f"{k}_general" for k in GENERAL_PATHS}
    p0, p1 = build_pyramid(tp.t(imgs0), 4), build_pyramid(tp.t(imgs1), 4)
    cfg = KLTConfig(n_levels=4, window_radius=RADIUS)
    got = klt_track(p0, p1, tp.t(pos), tp.t(valid), cfg)
    want = klt_track_plain(p0, p1, tp.t(pos), tp.t(valid), cfg)
    for a, b in zip(got, want):
        assert a.device.type == "cpu" and a.equal(b)
    blocks = extract_ncc_blocks_batched(p0.imgs[0], tp.t(pos), RADIUS)
    for a, b in zip(blocks, extract_ncc_blocks_batched_plain(
            p0.imgs[0], tp.t(pos), RADIUS)):
        assert a.equal(b)
    centers = tp.t(np.full((4, 2), [80.0, 60.0], np.float32))
    tmpl = blocks[0][0, :4].contiguous()
    got = ncc_search(p0.imgs[0][0], centers, tmpl, search_radius=SEARCH,
                     patch_radius=RADIUS)
    want = ncc_search_plain(p0.imgs[0][0], centers, tmpl,
                            search_radius=SEARCH, patch_radius=RADIUS)
    for a, b in zip(got, want):
        assert a.equal(b)
    assert launch_counts() == n0
    klt_track.general_launches += 1
    ncc_search.launches += 2
    reset_launch_counts()
    assert set(launch_counts().values()) == {0}


@pytest.fixture(scope="module")
def engines():
    """(JAX run, port run, Rs_gt, ts_gt) of both engines at radius 9 over
    the mono room, the port taking over the JAX bootstrap."""
    frames, Rs, ts = tp.scene(1, F)
    ref = tp.run_jax_engine(frames, cfg_mut=radius9)
    port = tp.run_port_engine(frames, handover=ref["boot"], cfg_mut=radius9)
    return ref, port, Rs, ts


def test_engines_at_radius_9_take_the_radius(engines):
    """Both engines hold 19x19 NCC blocks in their map tables."""
    ref, port, _, _ = engines
    for run in (ref, port):
        cfg = run["engine"].cfg
        assert cfg.klt.window_radius == cfg.p.ncc_patch_radius == RADIUS
        assert tuple(run["engine"].state.mappts.ncc.shape[1:]) == \
            (1, (2 * RADIUS + 1) ** 2)
    assert port["n_map"] > 0 and ref["n_map"] > 0


def test_engines_at_radius_9_bootstrap_and_log_every_frame(engines):
    ref, port, Rs, _ = engines
    tp.check_bootstrap_and_logged_frames(ref, port, Rs.shape[1])


def test_engines_at_radius_9_keyframes(engines):
    ref, port, _, _ = engines
    tp.check_keyframes(ref, port)


def test_engines_at_radius_9_ate(engines):
    tp.check_ate(*engines, 0.20)


def test_engines_at_radius_9_centres_agree(engines):
    ref, port, Rs, _ = engines
    tp.check_centres(ref, port, Rs.shape[0])
    assert torch.isfinite(torch.as_tensor(port["traj"][1])).all()
