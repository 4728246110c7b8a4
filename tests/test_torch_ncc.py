"""The NCC functions whose CUDA tensors run a kernel of their own
(``extract_ncc_blocks_batched`` -> ``csrc/ncc_blocks.cu``, ``ncc_search``
-> ``csrc/ncc_search.cu``): their plain versions, which CPU tensors take,
against the JAX package at the engine's shapes, and the dispatch rule.

Tolerances: the blocks' windows and bilinear shift are the same rounded
arithmetic in both packages; the mean and norm sum in another order, so
blocks agree within 1e-5 and the valid flags exactly. The search's
correlations sum in another order (a convolution in each package), so
the best pixel agrees on >= 99% of the centres and the scores within
1e-4; on a flat region every offset ties exactly and both take the first
(offset 0), the rule the kernel keeps."""

import numpy as np
import pytest
import jax.numpy as jnp

import torch_parity as tp


@pytest.mark.parametrize("radius", [3, 5, 7, 9])
def test_ncc_blocks_batched_engine_shape(rng, radius):
    """Three cameras, N = 1024 each, on 120x160 textures: positions over
    and past the image, on the in-bounds limits, one NaN, and a
    textureless strip."""
    from coslam_tpu.ops import ncc as jn
    from coslam_torch.ops import ncc as tn
    C, h, w, n = 3, 120, 160, 1024
    imgs = np.concatenate([tp.smooth_texture(rng, h, w) for _ in range(C)])
    imgs[2, :, 60:100] = 7.0
    pos = rng.uniform([-6, -6], [w + 6, h + 6], (C, n, 2)).astype(np.float32)
    pos[0, :4] = [[radius, radius], [w - 1.001 - radius, h - 1.001 - radius],
                  [radius - 0.01, 40.5], [w - 1.0 - radius, 40.5]]
    pos[1, 0] = np.nan
    jb, jok = jn.extract_ncc_blocks_batched(jnp.asarray(imgs),
                                            jnp.asarray(pos), radius)
    tb, tok = tn.extract_ncc_blocks_batched(tp.t(imgs), tp.t(pos), radius)
    jok = np.asarray(jok)
    np.testing.assert_array_equal(tp.n(tok), jok)
    np.testing.assert_allclose(tp.n(tb), np.asarray(jb), atol=1e-5)
    assert jok[0, :2].all() and not jok[0, 2:4].any() and not jok[1, 0]
    strip = (pos[2, :, 0] > 60 + radius + 1) & \
        (pos[2, :, 0] < 100 - radius - 2) & (pos[2, :, 1] > 2 * radius) & \
        (pos[2, :, 1] < h - 2 * radius)
    assert strip.sum() > 50 and not jok[2][strip].any()
    assert 0.5 * C * n < jok.sum() < C * n


def test_ncc_search_flat_region_takes_offset_zero(rng):
    """Centres on a flat region: every offset of a search scores the same,
    in both packages, so both pick the first, offset 0 (best pixel =
    rounded centre - search radius), with zero templates (score 0) and
    with unit-norm ones."""
    from coslam_tpu.ops import ncc as jn
    from coslam_torch.ops import ncc as tn
    img = np.full((120, 160), 93.0, np.float32)
    img[:, 130:] = rng.uniform(0, 255, (120, 30))
    centers = rng.uniform(30, [80, 90], (40, 2)).astype(np.float32)
    tmpl = rng.standard_normal((40, 121)).astype(np.float32)
    tmpl -= tmpl.mean(1, keepdims=True)
    tmpl /= np.linalg.norm(tmpl, axis=1, keepdims=True)
    tmpl[:20] = 0.0
    jpx, jsc = jn.ncc_search(jnp.asarray(img), jnp.asarray(centers),
                             jnp.asarray(tmpl), search_radius=16,
                             patch_radius=5)
    tpx, tsc = tn.ncc_search(tp.t(img), tp.t(centers), tp.t(tmpl),
                             search_radius=16, patch_radius=5)
    first = np.round(centers) - 16
    np.testing.assert_array_equal(np.asarray(jpx), first)
    np.testing.assert_array_equal(tp.n(tpx), first)
    assert (np.asarray(jsc)[:20] == 0).all() and (tp.n(tsc)[:20] == 0).all()


def test_ncc_search_default_radius(rng):
    """The default search radius (6: G = 23), N = 256 on 120x160: the same
    best pixel on >= 99% of the centres, scores within 1e-4, NCC_INVALID
    where the window clamps."""
    from coslam_tpu.ops import ncc as jn
    from coslam_torch.ops import ncc as tn
    img = tp.smooth_texture(rng, 120, 160, passes=1)[0]
    true = np.round(rng.uniform(22, [138, 98], (256, 2))).astype(np.float32)
    centers = true + rng.integers(-3, 4, (256, 2)).astype(np.float32)
    centers[:3] = [[4, 60], [80, 117], [155, 8]]
    blocks, _ = jn.extract_ncc_blocks(jnp.asarray(img), jnp.asarray(true), 5)
    jpx, jsc = jn.ncc_search(jnp.asarray(img), jnp.asarray(centers), blocks)
    tpx, tsc = tn.ncc_search(tp.t(img), tp.t(centers),
                             tp.t(np.asarray(blocks)))
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


def test_ncc_wrappers_launch_nothing_on_cpu(rng):
    """CPU tensors take the plain versions (bit for bit) and launch no
    kernel: every launch counter stays where it was."""
    from coslam_torch.ops import ncc as tn
    from coslam_torch.ops.klt import klt_track
    from coslam_torch.ops.patches import extract_windows
    from coslam_torch.ops.pyramid import build_pyramid
    counters = (build_pyramid, klt_track, extract_windows,
                tn.extract_ncc_blocks_batched, tn.ncc_search)
    n0 = [f.launches for f in counters]
    imgs = tp.t(np.concatenate([tp.smooth_texture(rng, 60, 80)
                                for _ in range(2)]))
    pos = tp.t(rng.uniform(-2, 70, (2, 30, 2)).astype(np.float32))
    got = tn.extract_ncc_blocks_batched(imgs, pos, 5)
    want = tn.extract_ncc_blocks_batched_plain(imgs, pos, 5)
    for a, b in zip(got, want):
        assert a.device.type == "cpu" and a.equal(b)
    one = tn.extract_ncc_blocks(imgs[1], pos[1], 3)
    for a, b in zip(one, tn.extract_ncc_blocks_batched_plain(
            imgs[1:], pos[1:], 3)):
        assert a.equal(b[0])
    tmpl = got[0][0]
    got = tn.ncc_search(imgs[0], pos[0] + 3.0, tmpl, search_radius=8)
    want = tn.ncc_search_plain(imgs[0], pos[0] + 3.0, tmpl, search_radius=8)
    for a, b in zip(got, want):
        assert a.device.type == "cpu" and a.equal(b)
    assert [f.launches for f in counters] == n0
