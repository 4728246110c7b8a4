"""Front-end parity: ``coslam_torch.ops`` against ``coslam_tpu.ops`` on the
same numpy images (filters, the two kernels' plain versions, pyramid,
sampling, KLT, corners, NCC).

Tolerances:
- K2 (window extraction) copies pixels: bit for bit.
- K1 (a pyramid level) and the other filters run the same taps in the
  same order, ≤ 1e-3 absolute on 0..255 images (the bound of
  tests/test_pyramid_pallas.py); in practice they agree to float32
  rounding.
- KLT and corners are decision procedures on those floats: positions to
  1e-3 px and the same valid flags and corner sets, allowing a feature
  or two at a threshold."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import torch_parity as tp

K1_TOL = 1e-3


def jimg(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("shape", [(1, 150, 200), (2, 61, 83), (1, 480, 640)])
def test_filters_match(rng, shape):
    from coslam_tpu.ops import image as ji
    from coslam_torch.ops import image as ti
    img = rng.uniform(0, 255, shape).astype(np.float32)
    pairs = [
        (ji.gaussian_blur(jimg(img)), ti.gaussian_blur(tp.t(img))),
        (ji.downsample2(jimg(img)), ti.downsample2(tp.t(img))),
        (ji.box_filter(jimg(img), 3), ti.box_filter(tp.t(img), 3)),
        (ji.max_pool_same(jimg(img), 5), ti.max_pool_same(tp.t(img), 5)),
    ]
    pairs += list(zip(ji.sobel_derivatives(jimg(img)),
                      ti.sobel_derivatives(tp.t(img))))
    for a, b in pairs:
        assert a.shape == tuple(b.shape)
        # rtol covers the box sums (up to ~1.3e4: a float32 ulp of 1e-3)
        np.testing.assert_allclose(tp.n(b), np.asarray(a), rtol=1e-6,
                                   atol=K1_TOL)


@pytest.mark.parametrize("shape,derivs", [((1, 480, 640), True),
                                          ((1, 240, 320), False),
                                          ((2, 120, 160), True),
                                          ((1, 60, 80), False),
                                          ((1, 37, 53), True)])
def test_k1_plain_matches_jax_xla(rng, shape, derivs):
    """K1's plain version against the JAX package's impl="xla" level (the
    ops/image.py filters) over the whole image, border frame included."""
    from coslam_tpu.ops.image import gaussian_blur, sobel_derivatives
    from coslam_torch.ops.pyramid import pyramid_level_plain
    img = rng.uniform(0, 255, shape).astype(np.float32)
    sm = gaussian_blur(jimg(img))
    want = (sm,) + tuple(sobel_derivatives(sm)) if derivs else (sm,)
    got = pyramid_level_plain(tp.t(img), derivs)
    got = got if derivs else (got,)
    for a, b in zip(want, got):
        d = np.abs(tp.n(b) - np.asarray(a)).max()
        assert d <= K1_TOL, d


def test_k1_interior_matches_pallas_interpret(rng):
    """And against the Pallas kernel itself (interpret mode): equal
    everywhere for the blur, in the interior for the derivatives (the
    Pallas kernel's outermost frame follows another edge convention)."""
    from coslam_tpu.ops.pyramid_pallas import pyramid_level_pallas
    from coslam_torch.ops.pyramid import pyramid_level_plain
    img = rng.uniform(0, 255, (1, 64, 128)).astype(np.float32)
    want = pyramid_level_pallas(jimg(img), interpret=True)
    got = pyramid_level_plain(tp.t(img), True)
    assert np.abs(tp.n(got[0]) - np.asarray(want[0])).max() <= K1_TOL
    for a, b in zip(want[1:], got[1:]):
        d = np.abs(tp.n(b) - np.asarray(a))[:, 1:-1, 1:-1].max()
        assert d <= K1_TOL


@pytest.mark.parametrize("n_levels", [1, 3, 4])
def test_build_pyramid_matches(rng, n_levels):
    from coslam_tpu.ops import build_pyramid as jbp
    from coslam_torch.ops import build_pyramid as tbp
    img = tp.smooth_texture(rng, 150, 200)
    a, b = jbp(jimg(img), n_levels, impl="xla"), tbp(tp.t(img), n_levels)
    assert b.n_levels == n_levels and len(b.dxs) == len(b.dys) == 1
    for x, y in zip(a.imgs + a.dxs + a.dys, b.imgs + b.dxs + b.dys):
        assert x.shape == tuple(y.shape)
        assert np.abs(tp.n(y) - np.asarray(x)).max() <= K1_TOL


@pytest.mark.parametrize("G", [12, 14, 23, 24])
def test_k2_plain_bit_exact_against_jax_gather(rng, G):
    """K2's plain version against the JAX package's gather path, bit for
    bit, origins out of range included (they clamp)."""
    from coslam_tpu.ops.patches import _extract_windows_gather
    from coslam_torch.ops.patches import extract_windows_plain
    C, h, w, n = 2, 60, 80, 97
    imgs = rng.uniform(0, 255, (C, h, w)).astype(np.float32)
    base = np.stack([rng.integers(-5, w - G + 6, (C, n)),
                     rng.integers(-5, h - G + 6, (C, n))], -1
                    ).astype(np.int32)
    want = np.asarray(_extract_windows_gather(jimg(imgs), jimg(base), G))
    got = tp.n(extract_windows_plain(tp.t(imgs), tp.t(base), G))
    assert got.shape == want.shape == (G, G, C, n)
    np.testing.assert_array_equal(got, want)


def test_sampling_and_patches(rng):
    from coslam_tpu.ops import patches as jp
    from coslam_torch.ops import patches as tpch
    img = rng.uniform(0, 255, (40, 50)).astype(np.float32)
    pts = rng.uniform(-2, 52, (200, 2)).astype(np.float32)
    jv, jok = jp.sample_bilinear(jimg(img), jimg(pts))
    tv, tok = tpch.sample_bilinear(tp.t(img), tp.t(pts))
    np.testing.assert_allclose(tp.n(tv), np.asarray(jv), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_array_equal(tp.n(tok), np.asarray(jok))
    np.testing.assert_array_equal(tp.n(tpch.patch_offsets(3)),
                                  np.asarray(jp.patch_offsets(3)))
    c = rng.uniform(0, 50, (30, 2)).astype(np.float32)
    jpch, jok = jp.extract_patches(jimg(img), jimg(c), 3)
    tpc, tok = tpch.extract_patches(tp.t(img), tp.t(c), 3)
    np.testing.assert_allclose(tp.n(tpc), np.asarray(jpch), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_array_equal(tp.n(tok), np.asarray(jok))
    Wnd = rng.uniform(0, 255, (9, 9, 30)).astype(np.float32)
    fx, fy = rng.uniform(0, 1, (2, 30)).astype(np.float32)
    np.testing.assert_allclose(
        tp.n(tpch.frac_shift(tp.t(Wnd), tp.t(fx), tp.t(fy))),
        np.asarray(jp.frac_shift(jimg(Wnd), jimg(fx), jimg(fy))),
        rtol=1e-6, atol=1e-4)


def _klt_case(rng, dx, dy, gain, n_levels, with_gain):
    from coslam_tpu.config import KLTConfig as JK
    from coslam_tpu.ops import build_pyramid as jbp
    from coslam_tpu.ops import klt_track as jklt
    from coslam_torch.config import KLTConfig as TK
    from coslam_torch.ops import klt_track as tklt
    h, w, n = 120, 160, 48
    img0 = tp.smooth_texture(rng, h, w)
    img1 = tp.shift_image(img0, dx, dy) * gain
    # mostly interior features, a few near the border (clamped windows)
    pos = rng.uniform([20, 20], [w - 20, h - 20], (1, n, 2))
    pos[0, :6] = rng.uniform([2, 2], [w - 3, h - 3], (6, 2))
    pos = pos.astype(np.float32)
    valid = rng.random((1, n)) > 0.1
    p0, p1 = jbp(jimg(img0), n_levels), jbp(jimg(img1), n_levels)
    jr = jklt(p0, p1, jimg(pos), jimg(valid),
              JK(n_levels=n_levels, track_with_gain=with_gain))
    # the port tracks on the same pyramids, so only KLT itself is compared
    tr = tklt(tp.pyramid_to_torch(p0), tp.pyramid_to_torch(p1), tp.t(pos),
              tp.t(valid), TK(n_levels=n_levels, track_with_gain=with_gain))
    return jr, tr


@pytest.mark.parametrize("dx,dy,gain,n_levels,with_gain", [
    (1.3, -0.7, 1.0, 3, False),
    (9.0, -6.0, 1.0, 4, False),
    (2.0, 1.0, 0.8, 3, True),
])
def test_klt_tracked_positions(rng, dx, dy, gain, n_levels, with_gain):
    jr, tr = _klt_case(rng, dx, dy, gain, n_levels, with_gain)
    jv, tv = np.asarray(jr.valid), tp.n(tr.valid)
    assert jv.sum() > 0.6 * jv.size
    assert (jv != tv).sum() <= 1
    both = jv & tv
    np.testing.assert_allclose(tp.n(tr.pos)[both], np.asarray(jr.pos)[both],
                               atol=1e-3)
    np.testing.assert_allclose(tp.n(tr.gain)[both],
                               np.asarray(jr.gain)[both], atol=1e-4)
    np.testing.assert_allclose(tp.n(tr.ssd)[both], np.asarray(jr.ssd)[both],
                               rtol=1e-3, atol=1e-2)


def _corner_case(rng, exclude):
    from coslam_tpu.config import KLTConfig as JK
    from coslam_tpu.ops import build_pyramid as jbp
    from coslam_tpu.ops import detect_corners as jdc
    from coslam_torch.config import KLTConfig as TK
    from coslam_torch.ops import detect_corners as tdc
    img = tp.smooth_texture(rng, 150, 200, passes=1)
    p = jbp(jimg(img), 1)
    tpyr = tp.pyramid_to_torch(p)
    kw_j, kw_t = {}, {}
    if exclude:
        ex = rng.uniform(0, 200, (1, 40, 2)).astype(np.float32)
        ok = rng.random((1, 40)) > 0.2
        kw_j = dict(exclude_pos=jimg(ex), exclude_valid=jimg(ok))
        kw_t = dict(exclude_pos=tp.t(ex), exclude_valid=tp.t(ok))
    out = []
    for k in (64, 2000):       # block-reduced top-k, then per-pixel top-k
        jr = jdc(p.imgs[0], p.dxs[0], p.dys[0],
                 JK(min_cornerness=10.0, min_distance=5), k, **kw_j)
        tr = tdc(tpyr.imgs[0], tpyr.dxs[0], tpyr.dys[0],
                 TK(min_cornerness=10.0, min_distance=5), k, **kw_t)
        out.append((jr, tr))
    return out


@pytest.mark.parametrize("exclude", [False, True])
def test_detect_corners_same_set_and_order(rng, exclude):
    for jr, tr in _corner_case(rng, exclude):
        jv, tv = np.asarray(jr.valid), tp.n(tr.valid)
        assert jv.sum() > 30
        np.testing.assert_array_equal(tv, jv)
        # same corners in the same order (ties: lower index first)
        np.testing.assert_array_equal(tp.n(tr.pos)[tv], np.asarray(jr.pos)[jv])
        np.testing.assert_allclose(tp.n(tr.score), np.asarray(jr.score),
                                   rtol=1e-4, atol=1e-3)


def test_cornerness_map(rng):
    from coslam_tpu.ops.corners import cornerness_map as jcm
    from coslam_torch.ops.corners import cornerness_map as tcm
    dx, dy = rng.standard_normal((2, 1, 50, 60)).astype(np.float32) * 20
    np.testing.assert_allclose(tp.n(tcm(tp.t(dx), tp.t(dy), 3)),
                               np.asarray(jcm(jimg(dx), jimg(dy), 3)),
                               rtol=1e-4, atol=1e-2)


def test_ncc_blocks(rng):
    from coslam_tpu.ops import ncc as jn
    from coslam_torch.ops import ncc as tn
    C, h, w, n = 2, 64, 80, 50
    imgs = np.concatenate([tp.smooth_texture(rng, h, w) for _ in range(C)])
    imgs[1, :, :20] = 7.0                          # a textureless strip
    pos = rng.uniform(-2, 82, (C, n, 2)).astype(np.float32)
    jb, jok = jn.extract_ncc_blocks_batched(jimg(imgs), jimg(pos), 5)
    tb, tok = tn.extract_ncc_blocks_batched(tp.t(imgs), tp.t(pos), 5)
    np.testing.assert_array_equal(tp.n(tok), np.asarray(jok))
    assert np.asarray(jok).sum() > 40
    np.testing.assert_allclose(tp.n(tb), np.asarray(jb), atol=1e-5)
    raw = rng.uniform(0, 255, (C, n, 121)).astype(np.float32)
    jo = jn._normalize_blocks(jimg(raw), jimg(pos), h, w, 5)
    to = tn._normalize_blocks(tp.t(raw), tp.t(pos), h, w, 5)
    np.testing.assert_allclose(tp.n(to[0]), np.asarray(jo[0]), atol=1e-5)
    np.testing.assert_array_equal(tp.n(to[1]), np.asarray(jo[1]))
