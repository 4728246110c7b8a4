"""Tests of the port that need a CUDA card: each CUDA kernel
(build_pyramid, klt_track, extract_windows, ncc_blocks, ncc_search)
against its plain PyTorch version at the main paths' shapes (one camera
and three; the loop closure's search), the wrappers' input checks, the
kernels' general paths for radii above the tuned ones (alone, and in an
engine run at radius 9 that launches only them), the engine on the
card against the same run on the CPU (one camera, and two on the rig),
a tracked step that never waits on the host, the overlap mode's pinned
buffers, asynchronous BA on a side stream, the batched render and the
distortion warp, checkpoints between the card and the CPU, and the
multi-device layer: the mesh step's pixel work on one card and over
distinct cards against the single-device step, the mesh step and the
distributed BA without a wait on the host, BA on another device.
Where no card is present each test skips (the decision is made inside
the ``cuda`` fixture, never at import).

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu
"""

import numpy as np
import pytest
import torch

import torch_parity as tp

pytestmark = pytest.mark.gpu



@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(1, 480, 640), (3, 480, 640),
                                   (2, 37, 53)])
def test_build_pyramid_kernel_bit_exact(cuda, shape):
    from coslam_torch.ops.pyramid import build_pyramid, build_pyramid_plain
    g = torch.Generator().manual_seed(0)
    img = (torch.rand(shape, generator=g) * 255).to(cuda)
    n0 = build_pyramid.launches
    got = build_pyramid(img, 4)
    assert build_pyramid.launches == n0 + 1
    want = build_pyramid_plain(img, 4)
    torch.cuda.synchronize()
    assert got.n_levels == 4
    for a, b in zip(got.imgs + got.dxs + got.dys,
                    want.imgs + want.dxs + want.dys):
        assert a.is_cuda and a.shape == b.shape
        assert torch.equal(a, b)


def _klt_inputs(C, h, w, n, seed):
    """Frames of a smooth texture shifted by a few px per camera (content
    moves by +d), features mostly inside, some within a few px of the
    border, 10% invalid on input, one NaN position."""
    rng = np.random.default_rng(seed)
    imgs0, imgs1 = [], []
    for c in range(C):
        img0 = tp.smooth_texture(rng, h, w)
        imgs0.append(img0)
        imgs1.append(tp.shift_image(img0, 2.6 - 3.1 * c, -1.4 + 2.2 * c))
    pos = rng.uniform([12, 12], [w - 12, h - 12], (C, n, 2))
    pos[:, :n // 20] = rng.uniform([0, 0], [w - 1, h - 1], (C, n // 20, 2))
    pos[:, n // 20:n // 10, 0] = rng.uniform(w - 6, w - 1, (C, n // 20))
    valid = rng.random((C, n)) > 0.1
    pos[C - 1, n - 1] = np.nan
    valid[C - 1, n - 1] = False
    return (np.concatenate(imgs0), np.concatenate(imgs1),
            pos.astype(np.float32), valid)


@pytest.mark.parametrize("shape,n,n_levels,with_gain", [
    ((1, 480, 640), 1024, 4, True),
    ((1, 480, 640), 1024, 4, False),
    ((3, 480, 640), 1024, 4, True),
    ((2, 150, 200), 300, 3, True),
])
def test_klt_track_kernel_matches_plain(cuda, shape, n, n_levels, with_gain):
    """Bands of tests/test_torch_ops.py::test_klt_tracked_positions: the
    kernel's 121-term sums run in another order, so `valid` may flip on
    at most 0.5% of the features valid on input (one at least), and where
    both keep a feature its position agrees to 1e-3 px, its gain to 1e-4
    and its SSD to rtol 1e-3 / atol 1e-2."""
    from coslam_torch.config import KLTConfig
    from coslam_torch.ops.klt import klt_track, klt_track_plain
    from coslam_torch.ops.pyramid import build_pyramid
    C, h, w = shape
    imgs0, imgs1, pos, valid = _klt_inputs(C, h, w, n, seed=h + n_levels)
    p0 = build_pyramid(torch.as_tensor(imgs0, device=cuda), n_levels)
    p1 = build_pyramid(torch.as_tensor(imgs1, device=cuda), n_levels)
    pos, valid = torch.as_tensor(pos, device=cuda), \
        torch.as_tensor(valid, device=cuda)
    cfg = KLTConfig(n_levels=n_levels, track_with_gain=with_gain)
    n0 = klt_track.launches
    got = klt_track(p0, p1, pos, valid, cfg)
    assert klt_track.launches == n0 + 1
    want = klt_track_plain(p0, p1, pos, valid, cfg)
    torch.cuda.synchronize()
    gv, wv, vin = (tp.n(x) for x in (got.valid, want.valid, valid))
    assert wv.sum() > 0.6 * vin.sum()
    assert (gv != wv)[vin].sum() <= max(1, 0.005 * vin.sum())
    assert not gv[C - 1, n - 1] and not wv[C - 1, n - 1]
    both = gv & wv
    np.testing.assert_allclose(tp.n(got.pos)[both], tp.n(want.pos)[both],
                               atol=1e-3)
    np.testing.assert_allclose(tp.n(got.gain)[both], tp.n(want.gain)[both],
                               atol=1e-4)
    np.testing.assert_allclose(tp.n(got.ssd)[both], tp.n(want.ssd)[both],
                               rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("G", [12, 14, 23, 24, 43])
def test_extract_windows_kernel_bit_exact(cuda, G):
    from coslam_torch.ops.patches import (extract_windows,
                                          extract_windows_plain)
    g = torch.Generator().manual_seed(G)
    for (C, h, w, n) in [(1, 480, 640, 1024), (3, 480, 640, 1024),
                         (2, 60, 80, 37)]:
        imgs = (torch.rand((C, h, w), generator=g) * 255).to(cuda)
        base = torch.stack([torch.randint(-4, w - G + 5, (C, n), generator=g),
                            torch.randint(-4, h - G + 5, (C, n), generator=g)],
                           -1).to(torch.int32).to(cuda)
        n0 = extract_windows.launches
        got = extract_windows(imgs, base, G)
        assert extract_windows.launches == n0 + 1
        torch.cuda.synchronize()
        assert torch.equal(got, extract_windows_plain(imgs, base, G))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from coslam_torch.config import KLTConfig
    from coslam_torch.ops.klt import klt_track
    from coslam_torch.ops.patches import extract_windows
    from coslam_torch.ops.pyramid import build_pyramid
    img = torch.rand((1, 64, 80), device=cuda) * 255
    base = torch.zeros((1, 8, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        build_pyramid(img.double(), 3)
    with pytest.raises(ValueError):
        build_pyramid(img[0], 3)
    with pytest.raises(ValueError):
        build_pyramid(img, 8)                  # 64 >> 7 == 0
    with pytest.raises(ValueError):
        build_pyramid(img, 0)
    pyr = build_pyramid(img, 2)
    pos = torch.full((1, 8, 2), 30.0, device=cuda)
    valid = torch.ones((1, 8), dtype=torch.bool, device=cuda)
    cfg = KLTConfig(n_levels=2)
    n0 = klt_track.launches
    with pytest.raises(ValueError):
        klt_track(pyr, pyr, pos.double(), valid, cfg)
    with pytest.raises(ValueError):
        klt_track(pyr, pyr, pos, valid.int(), cfg)
    with pytest.raises(ValueError):
        klt_track(pyr, pyr, pos, valid[:, :4], cfg)
    with pytest.raises(ValueError):
        klt_track(pyr, pyr, pos, valid, KLTConfig(n_levels=2,
                                                  window_radius=-1))
    with pytest.raises(ValueError):            # a 66-px window at r = 26
        klt_track(pyr, pyr, pos, valid, KLTConfig(n_levels=2,
                                                  window_radius=26))
    with pytest.raises(ValueError):
        klt_track(pyr, build_pyramid(img, 3), pos, valid, cfg)
    with pytest.raises(ValueError):
        klt_track(pyr, pyr._replace(imgs=(pyr.imgs[0].cpu(), pyr.imgs[1])),
                  pos, valid, cfg)
    small = build_pyramid(img[:, :20], 2)      # 20 px < the 24-px window
    with pytest.raises(ValueError):
        klt_track(small, small, pos, valid, cfg)
    assert klt_track.launches == n0
    with pytest.raises(ValueError):
        extract_windows(img, base.long(), 14)
    with pytest.raises(ValueError):
        extract_windows(img, base, 65)
    with pytest.raises(ValueError):
        extract_windows(img, base[:, ::2], 14)


def test_engine_on_the_card_matches_the_cpu(cuda):
    """30 frames at small_test_config(1, 150, 200) on the card and on the
    CPU: the same bootstrap frame and keyframes (one entry apart at
    most), both within the ATE bound, and on the card build_pyramid, klt_track
    and ncc_blocks launched and the window kernel not (its NCC uses are
    fused into ncc_blocks)."""
    from coslam_torch.config import small_test_config
    from coslam_torch.io.ate import ate_rmse
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence)
    from coslam_torch.ops.klt import klt_track
    from coslam_torch.ops.ncc import extract_ncc_blocks_batched
    from coslam_torch.ops.patches import extract_windows
    from coslam_torch.ops.pyramid import build_pyramid
    from coslam_torch.slam.pipeline import CoSlamEngine
    planes = make_room(np.random.default_rng(0), size=10.0)
    Rs, ts = orbit_trajectory(30, forward=0.06)
    frames = render_sequence(planes, tp.KMAT[0], Rs, ts, tp.H, tp.W,
                             device="cpu")
    counters = (build_pyramid, klt_track, extract_ncc_blocks_batched,
                extract_windows)
    runs = {}
    for dev in ("cpu", "cuda"):
        n0 = [f.launches for f in counters]
        eng = CoSlamEngine(small_test_config(1, tp.H, tp.W), tp.KMAT, tp.KC,
                           device=dev)
        for f in range(30):
            eng.process_frame(frames[f][None].to(dev))
        launched = [f.launches - n for f, n in zip(counters, n0)]
        runs[dev] = (eng, launched)
    (cpu, l_cpu), (gpu, l_gpu) = runs["cpu"], runs["cuda"]
    assert l_cpu == [0, 0, 0, 0]
    assert l_gpu[:2] == [30, 29] and l_gpu[2] > 0 and l_gpu[3] == 0
    assert tp.boot_frame(gpu.stats_log) == tp.boot_frame(cpu.stats_log)
    assert len(set(gpu.kf_frames) ^ set(cpu.kf_frames)) <= 2
    for eng in (cpu, gpu):
        assert ate_rmse(*eng.trajectory(0, True), Rs, ts) < 0.20


def test_ncc_blocks_on_the_card(cuda):
    """The NCC blocks of the three-camera step and of the map init (one
    camera at a time), one ncc_blocks launch each and no window launch,
    against the CPU: the shift is exact, the normalization's sums round
    within 1e-5."""
    from coslam_torch.ops.ncc import (extract_ncc_blocks,
                                      extract_ncc_blocks_batched)
    from coslam_torch.ops.patches import extract_windows
    rng = np.random.default_rng(5)
    imgs = np.concatenate([tp.smooth_texture(rng, 480, 640)
                           for _ in range(3)])
    pos = rng.uniform([-4, -4], [644, 484], (3, 1024, 2)).astype(np.float32)
    n0 = (extract_ncc_blocks_batched.launches, extract_windows.launches)
    got = extract_ncc_blocks_batched(tp.t(imgs).to(cuda),
                                     tp.t(pos).to(cuda), 5)
    one = extract_ncc_blocks(tp.t(imgs[1]).to(cuda), tp.t(pos[1]).to(cuda))
    assert (extract_ncc_blocks_batched.launches,
            extract_windows.launches) == (n0[0] + 2, n0[1])
    want = extract_ncc_blocks_batched(tp.t(imgs), tp.t(pos), 5)
    for g, w in ((got, want), (one, (want[0][1], want[1][1]))):
        np.testing.assert_array_equal(tp.n(g[1]), tp.n(w[1]))
        np.testing.assert_allclose(tp.n(g[0]), tp.n(w[0]), atol=1e-5)


def test_ncc_search_on_the_card(cuda):
    """Loop closure's template search at its shape (radius 16: G = 43,
    N = 256, one 480x640 image) on the card against the CPU: one
    ncc_search launch and no window launch; the sums run in another order,
    so the best pixel agrees on >= 99% of the centres and the scores to
    1e-4."""
    from coslam_torch.ops.ncc import extract_ncc_blocks, ncc_search
    from coslam_torch.ops.patches import extract_windows
    rng = np.random.default_rng(7)
    img = tp.t(tp.smooth_texture(rng, 480, 640, passes=1)[0])
    true = np.round(rng.uniform(30, [610, 450], (256, 2))).astype(np.float32)
    centers = true + rng.integers(-12, 13, (256, 2)).astype(np.float32)
    centers[:3] = [[5, 200], [300, 470], [630, 10]]     # windows clamp
    tmpl, _ = extract_ncc_blocks(img, tp.t(true), 5)
    n0 = (ncc_search.launches, extract_windows.launches)
    got = ncc_search(img.to(cuda), tp.t(centers).to(cuda), tmpl.to(cuda),
                     search_radius=16, patch_radius=5)
    assert (ncc_search.launches, extract_windows.launches) == \
        (n0[0] + 1, n0[1])
    want = ncc_search(img, tp.t(centers), tmpl, search_radius=16,
                      patch_radius=5)
    gpx, gsc, wpx, wsc = (tp.n(a) for a in (*got, *want))
    same = (gpx == wpx).all(1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(gsc[same], wsc[same], atol=1e-4)
    assert (wsc[:3] == -2.0).all() and (gsc[:3] == -2.0).all()
    assert (np.abs(wpx[3:] - true[3:]).max(1) == 0).mean() > 0.9


def test_two_camera_engine_on_the_card_matches_the_cpu(cuda):
    """20 frames of the two-camera rig at small_test_config(2, 150, 200) on
    the card and on the CPU: both bootstrap at frame 0, the same group
    ids, keyframes one entry apart at most, each camera's ATE under 0.25
    (the bound of tests/test_pipeline_multicam.py), and on the card
    build_pyramid once a frame, klt_track once a tracked frame, ncc_blocks
    launched and the window kernel not."""
    from coslam_torch.config import small_test_config
    from coslam_torch.io.ate import ate_rmse
    from coslam_torch.io.synthetic import (make_room, render_sequence,
                                           rig_sequence)
    from coslam_torch.ops.klt import klt_track
    from coslam_torch.ops.ncc import extract_ncc_blocks_batched
    from coslam_torch.ops.patches import extract_windows
    from coslam_torch.ops.pyramid import build_pyramid
    from coslam_torch.slam.pipeline import CoSlamEngine
    C, n = 2, 20
    planes = make_room(np.random.default_rng(0), size=10.0)
    Rs, ts = rig_sequence(C, n, baseline=1.0, forward=0.06)
    frames = torch.stack([render_sequence(planes, tp.KMAT[0], Rs[c], ts[c],
                                          tp.H, tp.W, device="cpu")
                          for c in range(C)], dim=1)
    counters = (build_pyramid, klt_track, extract_ncc_blocks_batched,
                extract_windows)
    runs = {}
    for dev in ("cpu", "cuda"):
        n0 = [f.launches for f in counters]
        eng = CoSlamEngine(small_test_config(C, tp.H, tp.W), *tp.kmats(C),
                           device=dev)
        for f in range(n):
            eng.process_frame(frames[f].to(dev))
        runs[dev] = (eng, [f.launches - k for f, k in zip(counters, n0)])
    (cpu, l_cpu), (gpu, l_gpu) = runs["cpu"], runs["cuda"]
    assert l_cpu == [0, 0, 0, 0]
    assert l_gpu[:2] == [n, n - 1] and l_gpu[2] > 0 and l_gpu[3] == 0
    assert tp.boot_frame(gpu.stats_log) == tp.boot_frame(cpu.stats_log) == 0
    np.testing.assert_array_equal(gpu.group_id, cpu.group_id)
    assert len(set(gpu.kf_frames) ^ set(cpu.kf_frames)) <= 2
    for eng in (cpu, gpu):
        for c in range(C):
            assert ate_rmse(*eng.trajectory(c, True), Rs[c], ts[c]) < 0.25


def _ncc_block_inputs(C, h, w, n, radius, seed):
    """Smooth textures with a textureless strip on the last camera,
    positions over and past the image (some out of range), positions on
    the in-bounds limits and one NaN."""
    rng = np.random.default_rng(seed)
    imgs = np.concatenate([tp.smooth_texture(rng, h, w) for _ in range(C)])
    imgs[C - 1, :, 300:360] = 7.0
    pos = rng.uniform([-6, -6], [w + 6, h + 6], (C, n, 2)).astype(np.float32)
    pos[0, :4] = [[radius, radius], [w - 1.001 - radius, h - 1.001 - radius],
                  [radius - 0.01, 40.5], [w - 1.0 - radius, 40.5]]
    pos[0, 4] = np.nan
    return imgs, pos


@pytest.mark.parametrize("C,radius", [(1, 5), (3, 5), (3, 3), (3, 7),
                                     (3, 9), (1, 9)])
def test_ncc_blocks_kernel_matches_plain(cuda, C, radius):
    """One ncc_blocks launch against the plain version on the card (its
    windows cut by the window kernel) at N = 1024 per 480x640 camera: the
    shift is the same rounded arithmetic, the two sums run in another
    order, so the blocks agree within 1e-5 and `ok` is identical."""
    from coslam_torch.ops.ncc import (extract_ncc_blocks_batched,
                                      extract_ncc_blocks_batched_plain)
    imgs, pos = _ncc_block_inputs(C, 480, 640, 1024, radius, seed=C + radius)
    imgs, pos = tp.t(imgs).to(cuda), tp.t(pos).to(cuda)
    n0 = extract_ncc_blocks_batched.launches
    blocks, ok = extract_ncc_blocks_batched(imgs, pos, radius)
    assert extract_ncc_blocks_batched.launches == n0 + 1
    want_b, want_ok = extract_ncc_blocks_batched_plain(imgs, pos, radius)
    torch.cuda.synchronize()
    S = 2 * radius + 1
    assert blocks.shape == (C, 1024, S * S) and blocks.is_contiguous()
    assert ok.dtype == torch.bool and ok.shape == (C, 1024)
    np.testing.assert_array_equal(tp.n(ok), tp.n(want_ok))
    np.testing.assert_allclose(tp.n(blocks), tp.n(want_b), atol=1e-5)
    okn = tp.n(ok)
    assert okn[0, :2].all() and not okn[0, 2:5].any()
    assert 0.5 * C * 1024 < okn.sum() < C * 1024
    assert (tp.n(blocks)[~okn] == 0).all()


def _search_inputs(h, w, n, sr, seed, patch_radius=5):
    """A one-pass smooth texture, templates cut at integer true positions,
    centres up to sr - 4 px off them, the first three centres so near the
    border that their windows clamp."""
    from coslam_torch.ops.ncc import extract_ncc_blocks
    rng = np.random.default_rng(seed)
    img = tp.t(tp.smooth_texture(rng, h, w, passes=1)[0])
    m = 2 * sr + 10
    true = np.round(rng.uniform(m, [w - m, h - m], (n, 2))).astype(np.float32)
    off = rng.integers(-(sr - 4), sr - 3, (n, 2)).astype(np.float32)
    centers = true + off
    centers[:3] = [[5, h / 2], [w / 2, h - 3], [w - 4, 10]]
    tmpl, _ = extract_ncc_blocks(img, tp.t(true), patch_radius)
    return img, tp.t(centers), tmpl, true


@pytest.mark.parametrize("search_radius", [16, 6])
def test_ncc_search_kernel_matches_plain(cuda, search_radius):
    """One ncc_search launch against the plain version on the card at the
    loop closure's search (radius 16: G = 43, N = 256) and the default
    radius (6: G = 23): the same best pixel on >= 99% of the centres,
    scores within 1e-4 where both agree, NCC_INVALID on the clamped
    centres, and the true pixel found on most of the others."""
    from coslam_torch.ops.ncc import ncc_search, ncc_search_plain
    img, centers, tmpl, true = _search_inputs(480, 640, 256, search_radius,
                                              seed=search_radius)
    args = (img.to(cuda), centers.to(cuda), tmpl.to(cuda))
    n0 = ncc_search.launches
    got = ncc_search(*args, search_radius=search_radius, patch_radius=5)
    assert ncc_search.launches == n0 + 1
    want = ncc_search_plain(*args, search_radius=search_radius,
                            patch_radius=5)
    gpx, gsc, wpx, wsc = (tp.n(a) for a in (*got, *want))
    same = (gpx == wpx).all(1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(gsc[same], wsc[same], atol=1e-4)
    assert (gsc[:3] == -2.0).all() and (wsc[:3] == -2.0).all()
    assert (gsc[3:] > -2.0).all()
    assert (np.abs(gpx[3:] - true[3:]).max(1) == 0).mean() > 0.9


def test_ncc_search_kernel_takes_the_first_of_tied_offsets(cuda):
    """Centres on a flat region: every offset of a search scores the same,
    so the kernel, as torch.argmax, picks offset 0 (best pixel = rounded
    centre - search radius), with zero templates (as the plain version
    does, at score 0) and with random ones."""
    from coslam_torch.ops.ncc import ncc_search, ncc_search_plain
    rng = np.random.default_rng(3)
    img = np.full((200, 240), 93.0, np.float32)
    img[:, 200:] = rng.uniform(0, 255, (200, 40))
    centers = rng.uniform(40, [150, 150], (64, 2)).astype(np.float32)
    tmpl = rng.standard_normal((64, 121)).astype(np.float32)
    tmpl[:32] = 0.0
    args = [tp.t(a).to(cuda) for a in (img, centers, tmpl)]
    got = ncc_search(*args, search_radius=16, patch_radius=5)
    want = ncc_search_plain(*args, search_radius=16, patch_radius=5)
    first = np.round(centers) - 16
    np.testing.assert_array_equal(tp.n(got[0]), first)
    np.testing.assert_array_equal(tp.n(want[0])[:32], first[:32])
    assert (tp.n(got[1])[:32] == 0).all() and (tp.n(want[1])[:32] == 0).all()


def test_ncc_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from coslam_torch.ops.ncc import extract_ncc_blocks_batched, ncc_search
    imgs = torch.rand((2, 64, 80), device=cuda) * 255
    pos = torch.full((2, 8, 2), 30.0, device=cuda)
    n0 = extract_ncc_blocks_batched.launches
    for bad in [(imgs.double(), pos, 5), (imgs[0], pos[0], 5),
                (imgs.transpose(1, 2), pos, 5),
                (imgs, pos.double(), 5), (imgs, pos[:1], 5),
                (imgs, pos.cpu(), 5), (imgs, pos, 40), (imgs, pos, -1),
                (imgs[:, :11].contiguous(), pos, 5)]:
        with pytest.raises(ValueError):
            extract_ncc_blocks_batched(*bad)
    assert extract_ncc_blocks_batched.launches == n0
    img = imgs[0]
    ctr = torch.full((8, 2), 40.0, device=cuda)
    tmpl = torch.zeros((8, 121), device=cuda)
    n0 = ncc_search.launches
    for bad, kw in [((img.double(), ctr, tmpl), {}),
                    ((imgs, ctr, tmpl), {}),
                    ((img.t(), ctr, tmpl), {}),
                    ((img, ctr.double(), tmpl), {}),
                    ((img, ctr, tmpl[:4]), {}),
                    ((img, ctr, tmpl[:, :49]), {}),
                    ((img, ctr, tmpl.t().contiguous().t()), {}),
                    ((img, ctr.cpu(), tmpl), {}),
                    ((img, ctr, tmpl), {"patch_radius": -1}),
                    ((img, ctr, tmpl), {"search_radius": -1}),
                    ((img, ctr, tmpl), {"search_radius": 30})]:
        with pytest.raises(ValueError):
            ncc_search(*bad, **kw)
    assert ncc_search.launches == n0


# ------------------------------------------------- general radius paths ----

@pytest.mark.parametrize("radius", [9])
def test_klt_track_general_path_matches_plain(cuda, radius):
    """klt_track at a window radius above the tuned path's 7 (the general
    path: windows in dynamic shared memory, per-pixel terms recomputed)
    against the plain version, in the bands of
    test_klt_track_kernel_matches_plain."""
    from coslam_torch.config import KLTConfig
    from coslam_torch.ops.klt import klt_track, klt_track_plain
    from coslam_torch.ops.pyramid import build_pyramid
    C, h, w, n = 1, 480, 640, 1024
    imgs0, imgs1, pos, valid = _klt_inputs(C, h, w, n, seed=radius)
    p0 = build_pyramid(torch.as_tensor(imgs0, device=cuda), 4)
    p1 = build_pyramid(torch.as_tensor(imgs1, device=cuda), 4)
    pos, valid = torch.as_tensor(pos, device=cuda), \
        torch.as_tensor(valid, device=cuda)
    cfg = KLTConfig(n_levels=4, window_radius=radius)
    n0 = klt_track.launches
    got = klt_track(p0, p1, pos, valid, cfg)
    assert klt_track.launches == n0 + 1
    want = klt_track_plain(p0, p1, pos, valid, cfg)
    torch.cuda.synchronize()
    gv, wv, vin = (tp.n(x) for x in (got.valid, want.valid, valid))
    assert wv.sum() > 0.6 * vin.sum()
    assert (gv != wv)[vin].sum() <= max(1, 0.005 * vin.sum())
    both = gv & wv
    np.testing.assert_allclose(tp.n(got.pos)[both], tp.n(want.pos)[both],
                               atol=1e-3)
    np.testing.assert_allclose(tp.n(got.gain)[both], tp.n(want.gain)[both],
                               atol=1e-4)
    np.testing.assert_allclose(tp.n(got.ssd)[both], tp.n(want.ssd)[both],
                               rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("patch_radius,search_radius", [(9, 24), (5, 24)])
def test_ncc_search_general_path_matches_plain(cuda, patch_radius,
                                               search_radius):
    """ncc_search at radii above the tuned path's (patch 7, search 20),
    against the plain version in the bands of
    test_ncc_search_kernel_matches_plain."""
    from coslam_torch.ops.ncc import ncc_search, ncc_search_plain
    img, centers, tmpl, true = _search_inputs(
        480, 640, 256, search_radius, seed=search_radius,
        patch_radius=patch_radius)
    args = (img.to(cuda), centers.to(cuda), tmpl.to(cuda))
    kw = dict(search_radius=search_radius, patch_radius=patch_radius)
    n0 = ncc_search.launches
    got = ncc_search(*args, **kw)
    assert ncc_search.launches == n0 + 1
    want = ncc_search_plain(*args, **kw)
    gpx, gsc, wpx, wsc = (tp.n(a) for a in (*got, *want))
    same = (gpx == wpx).all(1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(gsc[same], wsc[same], atol=1e-4)
    assert (gsc[:3] == -2.0).all() and (wsc[:3] == -2.0).all()
    assert (np.abs(gpx[3:] - true[3:]).max(1) == 0).mean() > 0.9


def test_engine_at_radius_9_runs_the_general_kernels(cuda):
    """20 frames of the two-camera engine (the rig of
    test_two_camera_engine_on_the_card_matches_the_cpu) with the KLT
    window radius and the NCC patch radius at 9: klt_track takes its
    general kernel on every frame after the first, ncc_blocks on every
    launch, and neither tuned kernel launches; the run bootstraps at
    frame 0 with its poses under that test's ATE bound."""
    import dataclasses
    from coslam_torch.config import small_test_config
    from coslam_torch.io.ate import ate_rmse
    from coslam_torch.ops import launch_counts
    from coslam_torch.slam.pipeline import CoSlamEngine
    C, n = 2, 20
    frames, Rs, ts = _card_frames(C, n)
    cfg = small_test_config(C, tp.H, tp.W)
    cfg = cfg.replace(
        klt=dataclasses.replace(cfg.klt, window_radius=9),
        p=dataclasses.replace(cfg.p, ncc_patch_radius=9))
    eng = CoSlamEngine(cfg, *tp.kmats(C), device=cuda)
    n0 = launch_counts()
    for f in range(n):
        eng.process_frame(frames[f])
    torch.cuda.synchronize()
    got = {k: v - n0[k] for k, v in launch_counts().items()}
    assert got["klt_track"] == got["klt_track_general"] == n - 1
    assert got["ncc_blocks"] == got["ncc_blocks_general"] > 0
    assert got["ncc_search"] == got["ncc_search_general"] == 0
    assert tuple(eng.state.mappts.ncc.shape[1:]) == (C, 19 * 19)
    assert tp.boot_frame(eng.stats_log) == 0
    for c in range(C):
        assert ate_rmse(*eng.trajectory(c, True), Rs[c], ts[c]) < 0.25


# ------------------------------------------------------- engine modes ----

def _card_frames(C, n_frames):
    """The port's render on the card: the mono room, or the C-camera rig
    ([F, C, H, W]), with ground truth [C, F]."""
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence, rig_sequence)
    planes = make_room(np.random.default_rng(0), size=10.0)
    if C == 1:
        Rs, ts = orbit_trajectory(n_frames, forward=0.06)
        Rs, ts = Rs[None], ts[None]
    else:
        Rs, ts = rig_sequence(C, n_frames, baseline=1.0, forward=0.06)
    frames = torch.stack([render_sequence(planes, tp.KMAT[0], Rs[c], ts[c],
                                          tp.H, tp.W, device="cuda")
                          for c in range(C)], dim=1)
    return frames, Rs, ts


def _engine(C, device, **kw):
    from coslam_torch.config import small_test_config
    from coslam_torch.slam.pipeline import CoSlamEngine
    return CoSlamEngine(small_test_config(C, tp.H, tp.W), *tp.kmats(C),
                        device=device, **kw)


@pytest.mark.parametrize("C,large_err", [(1, False), (1, True), (3, False),
                                         (3, True)])
def test_frame_step_never_waits_on_the_host(cuda, C, large_err):
    """A warmed tracked step (and its stats packing) enqueues with no
    synchronizing call: under set_sync_debug_mode("error") any blocking
    copy or stream sync raises."""
    from coslam_torch.slam.fused import frame_step_packed
    frames, _, _ = _card_frames(C, 14)
    eng = _engine(C, cuda)
    for f in range(12):
        eng.process_frame(frames[f])
    assert eng.bootstrapped
    args = (eng.K, eng.kc, eng.cfg)
    st, pyr, _ = frame_step_packed(eng.state, eng.pyr_prev, frames[12],
                                   *args, large_err=large_err)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, pyr, v = frame_step_packed(st, pyr, frames[13], *args,
                                       large_err=large_err)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(v).all()


def test_overlap_reads_pinned_buffers(cuda):
    """Overlap mode copies each frame's stats into pinned host memory
    (two buffers in turn) behind a CUDA event."""
    frames, _, _ = _card_frames(1, 16)
    eng = _engine(1, cuda, overlap=True)
    bufs = set()
    for f in range(16):
        eng.process_frame(frames[f])
        if eng._pending_fs is not None:
            buf, done = eng._pending_fs[1]
            assert buf.is_pinned() and isinstance(done, torch.cuda.Event)
            bufs.add(buf.data_ptr())
    assert len(bufs) == 2
    eng.trajectory(0)
    assert eng._pending_fs is None


def test_async_ba_on_a_side_stream(cuda):
    """async_ba on the card: the solves run on a stream of their own and
    are applied through their events (at this size a solve has finished by
    the poll right after its dispatch), the run agrees with the CPU's
    async run in the band of the engine test above (bootstrap frame,
    keyframes two entries apart, ATE, centres within 5% of the path), and
    a solve cancelled in flight leaves the state as it was."""
    from coslam_torch.io.ate import ate_rmse
    from coslam_torch.slam.state import state_to_numpy
    frames, Rs, ts = _card_frames(1, 30)
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = _engine(1, dev, async_ba=True)
        for f in range(30):
            eng.process_frame(frames[f].to(dev))
        eng._apply_pending_ba()
        runs[dev] = eng
    cpu, gpu = runs["cpu"], runs["cuda"]
    assert gpu._ba_stream is not None
    assert gpu._ba_stream != torch.cuda.default_stream()
    assert gpu.ba_async["dispatched"] >= 2 and gpu.ba_async["ready"] >= 1
    assert gpu.ba_async["dispatched"] == sum(
        gpu.ba_async[k] for k in ("ready", "deferred", "flushed",
                                  "cancelled"))
    assert tp.boot_frame(gpu.stats_log) == tp.boot_frame(cpu.stats_log)
    assert len(set(gpu.kf_frames) ^ set(cpu.kf_frames)) <= 2
    for eng in (cpu, gpu):
        assert ate_rmse(*eng.trajectory(0, True), Rs[0], ts[0]) < 0.20
    gap, path = tp.aligned_gap(gpu.trajectory(0, True),
                               cpu.trajectory(0, True))
    assert gap < 0.05 * path
    # a solve cancelled in flight
    gpu._run_ba()
    assert gpu._pending_ba is not None
    before = tp.leaves(state_to_numpy(gpu.state))
    gpu._cancel_pending_ba()
    torch.cuda.synchronize()
    for a, b in zip(before, tp.leaves(state_to_numpy(gpu.state))):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------- multi-device layer ----

def _mesh_front_end(mesh_devices, C=3):
    """One frame's pixel work (pyramid, KLT and corner refill, NCC blocks)
    of a bootstrapped C-camera engine on the card, the mesh's way (one
    camera a shard on ``mesh_devices``) and the single-device way, from the
    same state and reference pyramid."""
    from coslam_torch.ops.ncc import extract_ncc_blocks_batched
    from coslam_torch.ops.pyramid import build_pyramid
    from coslam_torch.parallel.mesh import make_cam_mesh
    from coslam_torch.slam import steps
    from coslam_torch.slam.fused import (shard_advance_tracks, shard_frames,
                                         shard_pyramid)
    frames, _, _ = _card_frames(C, 14)
    eng = _engine(C, "cuda")
    for f in range(13):
        eng.process_frame(frames[f])
    assert eng.bootstrapped
    cfg, st = eng.cfg, eng.state
    pyr = build_pyramid(frames[13], cfg.klt.n_levels)
    tracks = steps.advance_tracks(eng.pyr_prev, pyr, st.tracks, eng.K,
                                  eng.kc, st.frame + 1, cfg)
    blocks = extract_ncc_blocks_batched(pyr.imgs[0], tracks.raw,
                                        cfg.p.ncc_patch_radius)
    mesh = make_cam_mesh(devices=mesh_devices)
    sp = shard_pyramid(mesh, eng.pyr_prev, eng.frame - 1, eng.K, eng.kc)
    cur = sp.following(shard_frames(mesh, frames[13]))
    m_tracks, m_blocks = shard_advance_tracks(sp, cur, st.tracks, cfg)
    return st.tracks, (tracks, blocks), (m_tracks, m_blocks), mesh


def _assert_front_ends_agree(valid_in, single, sharded):
    """The KLT flip share of chip_smoke.py (0.5% of the features valid on
    input), positions within 1e-3 px where both keep a feature, the NCC
    blocks within 1e-5 where both cut one at the same position."""
    (t1, (b1, ok1)), (t2, (b2, ok2)) = single, sharded
    vin = valid_in.cpu()
    flips = int((t1.valid.cpu() != t2.valid.cpu())[vin].sum())
    assert flips <= max(1, 0.005 * int(vin.sum())), flips
    both = (t1.valid & t2.valid).cpu()
    assert float((t1.raw - t2.raw).abs().cpu()[both].max()) <= 1e-3
    same = (ok1 & ok2 & (t1.raw == t2.raw).all(-1)).cpu()
    assert same.sum() > 0.5 * both.sum()
    assert float((b1 - b2).abs().cpu()[same].max()) <= 1e-5


def test_mesh_front_end_on_one_card_matches_single_device(cuda):
    """The mesh step's pixel work on ["cuda:0"] * 3 against the same work
    on the whole camera batch."""
    tracks, single, sharded, mesh = _mesh_front_end([cuda] * 3)
    _assert_front_ends_agree(tracks.valid, single, sharded)
    assert mesh.census[("to_main", "ncc.blocks")] == 3


def test_mesh_front_end_over_distinct_cards(cuda):
    """The same over one card a camera (cuda:0, cuda:1, ... round robin):
    each shard's kernels launch on its own card."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two cards, the machine has {n}")
    devs = [f"cuda:{k % n}" for k in range(3)]
    tracks, single, sharded, _ = _mesh_front_end(devs)
    _assert_front_ends_agree(tracks.valid, single, sharded)


def test_mesh_step_and_dist_ba_never_wait_on_the_host(cuda):
    """A warmed mesh step (["cuda:0"] * 3, stats packed) and the
    distributed table BA enqueue with no synchronizing call."""
    from coslam_torch.parallel.dist_ba import dist_bundle_adjust_table
    from coslam_torch.parallel.mesh import make_cam_mesh
    from coslam_torch.slam.fused import frame_step_packed, shard_frames
    from coslam_torch.slam.steps import build_ba_table
    C = 3
    frames, _, _ = _card_frames(C, 15)
    mesh = make_cam_mesh(devices=[cuda] * C)
    eng = _engine(C, mesh.main, mesh=mesh)
    for f in range(13):
        eng.process_frame(frames[f])
    assert eng.bootstrapped
    args = (eng.K, eng.kc, eng.cfg)
    imgs = [shard_frames(mesh, frames[f]) for f in (13, 14)]
    st, pyr, _ = frame_step_packed(eng.state, eng.pyr_prev, imgs[0], *args,
                                   mesh=mesh)
    prob, _, _ = build_ba_table(st, eng.K, eng.cfg)
    P = prob.X.shape[0] - prob.X.shape[0] % C
    prob = type(prob)(prob.K, prob.R, prob.t, prob.X[:P],
                      prob.obs_px[..., :P], prob.obs_valid[:, :P],
                      prob.cam_fixed, prob.point_fixed[:P])
    dist_bundle_adjust_table(prob, mesh)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, pyr, v = frame_step_packed(st, pyr, imgs[1], *args, mesh=mesh)
        res = dist_bundle_adjust_table(prob, mesh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(v).all() and torch.isfinite(res.cost)


def test_async_ba_on_another_device(cuda):
    """async_ba with ``ba_device`` another device than the engine's card:
    cuda:1 where the machine has it, else the CPU. Every dispatched solve
    is applied, the run stays in the CPU run's ATE bound, and the result
    comes back to the engine's card."""
    from coslam_torch.io.ate import ate_rmse
    other = "cuda:1" if torch.cuda.device_count() > 1 else "cpu"
    print(f"BA on {other}")
    frames, Rs, ts = _card_frames(1, 30)
    eng = _engine(1, "cuda:0", async_ba=True, ba_device=other)
    for f in range(30):
        eng.process_frame(frames[f])
    eng._apply_pending_ba()
    ba = eng.ba_async
    assert ba["dispatched"] >= 2
    assert ba["dispatched"] == sum(ba[k] for k in ("ready", "deferred",
                                                   "flushed", "cancelled"))
    assert eng.state.kfs.R.device == torch.device("cuda:0")
    assert ate_rmse(*eng.trajectory(0, True), Rs[0], ts[0]) < 0.20


def test_render_batch_and_warp_on_the_card(cuda):
    """render_batch (moving quad, per-view frame indices) and the
    distortion warp on the card against the same calls on the CPU: the
    band of chip_smoke.py's render check (0.25 grey levels outside 0.1% of
    pixels, whose rays graze a seam between planes), and the warp of the
    same image within 1e-3 grey levels."""
    from coslam_torch.io.synthetic import (MovingQuad, apply_distortion_warp,
                                           make_room, make_texture,
                                           orbit_trajectory, render_batch)
    rng = np.random.default_rng(0)
    quad = MovingQuad(center0=np.array([-1.0, 0.5, 8.0], np.float32),
                      velocity=np.array([0.05, 0.0, 0.0], np.float32),
                      eu=np.array([1.6, 0, 0], np.float32),
                      ev=np.array([0, 1.6, 0], np.float32),
                      tex=make_texture(rng))
    planes = make_room(rng, size=10.0)
    Rs, ts = orbit_trajectory(10, forward=0.3, yaw_rate=0.05)
    frames = np.arange(10)[::-1].copy()
    out = {dev: render_batch(planes, tp.KMAT[0], Rs, ts, tp.H, tp.W,
                             quads=[quad], frames=frames, chunk=4,
                             device=dev) for dev in ("cpu", "cuda")}
    assert out["cuda"].is_cuda and out["cuda"].shape == (10, tp.H, tp.W)
    diff = (out["cuda"].cpu() - out["cpu"]).abs()
    assert float((diff > 0.25).float().mean()) <= 1e-3
    kc = np.array([-0.25, 0.08, 1e-3, -5e-4, 0.0], np.float32)
    warped = apply_distortion_warp(out["cpu"].to(cuda), tp.KMAT[0], kc)
    assert warped.is_cuda
    want = apply_distortion_warp(out["cpu"], tp.KMAT[0], kc)
    assert float((warped.cpu() - want).abs().max()) <= 1e-3


@pytest.mark.parametrize("saved_on,loaded_on", [("cuda", "cpu"),
                                                ("cpu", "cuda")])
def test_checkpoint_between_card_and_cpu(cuda, tmp_path, saved_on,
                                         loaded_on):
    """A checkpoint saved by an engine on one device loads into an engine
    on the other (state and pyramid on the loader's device) and runs on
    within the engine bands of the CPU tests against the saver's own
    continuation."""
    from coslam_torch.io.ate import ate_rmse
    from coslam_torch.io.checkpoint import load_checkpoint, save_checkpoint
    frames, Rs, ts = _card_frames(1, 30)
    saver = _engine(1, saved_on, log_features=True)
    for f in range(20):
        saver.process_frame(frames[f].to(saved_on))
    save_checkpoint(str(tmp_path / "ck.npz"), saver)
    for f in range(20, 30):
        saver.process_frame(frames[f].to(saved_on))
    eng = load_checkpoint(str(tmp_path / "ck.npz"), _engine(1, loaded_on))
    assert eng.frame == 20 and eng.state.R.device.type == loaded_on
    assert eng.pyr_prev.imgs[0].device.type == loaded_on
    for f in range(20, 30):
        eng.process_frame(frames[f].to(loaded_on))
    traj = eng.trajectory(0, True)
    assert ate_rmse(*traj, Rs[0], ts[0]) < 0.20
    gap, path = tp.aligned_gap(traj, saver.trajectory(0, True))
    assert gap < 0.05 * path
    assert [e[0] for e in saver.feat_log] == list(
        range(tp.boot_frame(saver.stats_log), 30))
