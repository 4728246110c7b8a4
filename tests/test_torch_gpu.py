"""Tests of the port that need a CUDA card: each CUDA kernel
(build_pyramid, klt_track, extract_windows) against its plain PyTorch
version at the main paths' shapes (one camera and three), the wrappers'
input checks, and the engine on the card against the same run on the CPU
(one camera, and two on the rig).
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


@pytest.mark.parametrize("G", [12, 14, 23, 24])
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
                                                  window_radius=8))
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
    most), both within the ATE bound, and both kernels launched on the
    card."""
    from coslam_torch.config import small_test_config
    from coslam_torch.io.ate import ate_rmse
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence)
    from coslam_torch.ops.klt import klt_track
    from coslam_torch.ops.patches import extract_windows
    from coslam_torch.ops.pyramid import build_pyramid
    from coslam_torch.slam.pipeline import CoSlamEngine
    planes = make_room(np.random.default_rng(0), size=10.0)
    Rs, ts = orbit_trajectory(30, forward=0.06)
    frames = render_sequence(planes, tp.KMAT[0], Rs, ts, tp.H, tp.W,
                             device="cpu")
    counters = (build_pyramid, klt_track, extract_windows)
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
    assert l_cpu == [0, 0, 0]
    assert l_gpu[:2] == [30, 29] and l_gpu[2] > 0
    assert tp.boot_frame(gpu.stats_log) == tp.boot_frame(cpu.stats_log)
    assert len(set(gpu.kf_frames) ^ set(cpu.kf_frames)) <= 2
    for eng in (cpu, gpu):
        assert ate_rmse(*eng.trajectory(0, True), Rs, ts) < 0.20


def test_ncc_blocks_on_the_card(cuda):
    """The NCC blocks of the three-camera step and of the map init (one
    camera at a time) cut by the window kernel, against the CPU: the
    window copies are exact, the shift and normalization round within
    1e-5."""
    from coslam_torch.ops.ncc import (extract_ncc_blocks,
                                      extract_ncc_blocks_batched)
    from coslam_torch.ops.patches import extract_windows
    rng = np.random.default_rng(5)
    imgs = np.concatenate([tp.smooth_texture(rng, 480, 640)
                           for _ in range(3)])
    pos = rng.uniform([-4, -4], [644, 484], (3, 1024, 2)).astype(np.float32)
    n0 = extract_windows.launches
    got = extract_ncc_blocks_batched(tp.t(imgs).to(cuda),
                                     tp.t(pos).to(cuda), 5)
    one = extract_ncc_blocks(tp.t(imgs[1]).to(cuda), tp.t(pos[1]).to(cuda))
    assert extract_windows.launches == n0 + 2
    want = extract_ncc_blocks_batched(tp.t(imgs), tp.t(pos), 5)
    for g, w in ((got, want), (one, (want[0][1], want[1][1]))):
        np.testing.assert_array_equal(tp.n(g[1]), tp.n(w[1]))
        np.testing.assert_allclose(tp.n(g[0]), tp.n(w[0]), atol=1e-5)


def test_two_camera_engine_on_the_card_matches_the_cpu(cuda):
    """20 frames of the two-camera rig at small_test_config(2, 150, 200) on
    the card and on the CPU: both bootstrap at frame 0, the same group
    ids, keyframes one entry apart at most, each camera's ATE under 0.25
    (the bound of tests/test_pipeline_multicam.py), and every kernel
    launched on the card (build_pyramid once a frame, klt_track once a
    tracked frame)."""
    from coslam_torch.config import small_test_config
    from coslam_torch.io.ate import ate_rmse
    from coslam_torch.io.synthetic import (make_room, render_sequence,
                                           rig_sequence)
    from coslam_torch.ops.klt import klt_track
    from coslam_torch.ops.patches import extract_windows
    from coslam_torch.ops.pyramid import build_pyramid
    from coslam_torch.slam.pipeline import CoSlamEngine
    C, n = 2, 20
    planes = make_room(np.random.default_rng(0), size=10.0)
    Rs, ts = rig_sequence(C, n, baseline=1.0, forward=0.06)
    frames = torch.stack([render_sequence(planes, tp.KMAT[0], Rs[c], ts[c],
                                          tp.H, tp.W, device="cpu")
                          for c in range(C)], dim=1)
    counters = (build_pyramid, klt_track, extract_windows)
    runs = {}
    for dev in ("cpu", "cuda"):
        n0 = [f.launches for f in counters]
        eng = CoSlamEngine(small_test_config(C, tp.H, tp.W), *tp.kmats(C),
                           device=dev)
        for f in range(n):
            eng.process_frame(frames[f].to(dev))
        runs[dev] = (eng, [f.launches - k for f, k in zip(counters, n0)])
    (cpu, l_cpu), (gpu, l_gpu) = runs["cpu"], runs["cuda"]
    assert l_cpu == [0, 0, 0]
    assert l_gpu[:2] == [n, n - 1] and l_gpu[2] > 0
    assert tp.boot_frame(gpu.stats_log) == tp.boot_frame(cpu.stats_log) == 0
    np.testing.assert_array_equal(gpu.group_id, cpu.group_id)
    assert len(set(gpu.kf_frames) ^ set(cpu.kf_frames)) <= 2
    for eng in (cpu, gpu):
        for c in range(C):
            assert ate_rmse(*eng.trajectory(c, True), Rs[c], ts[c]) < 0.25
