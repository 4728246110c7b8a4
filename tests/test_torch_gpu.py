"""Tests of the port that need a CUDA card: each CUDA kernel against its
plain PyTorch version at the main path's shapes, the wrappers' input
checks, and the engine on the card against the same run on the CPU.
Where no card is present each test skips (the decision is made inside
the ``cuda`` fixture, never at import).

    python -m pytest tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

import torch_parity as tp

pytestmark = pytest.mark.gpu

K1_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,derivs", [((1, 480, 640), True),
                                          ((1, 240, 320), False),
                                          ((1, 120, 160), False),
                                          ((1, 60, 80), False),
                                          ((2, 37, 53), True)])
def test_pyramid_level_kernel_matches_plain(cuda, shape, derivs):
    from coslam_torch.ops.pyramid import pyramid_level, pyramid_level_plain
    g = torch.Generator().manual_seed(0)
    img = (torch.rand(shape, generator=g) * 255).to(cuda)
    n0 = pyramid_level.launches
    got = pyramid_level(img, derivs)
    assert pyramid_level.launches == n0 + 1
    want = pyramid_level_plain(img, derivs)
    torch.cuda.synchronize()
    got, want = (got, want) if derivs else ((got,), (want,))
    for a, b in zip(got, want):
        assert a.is_cuda and a.shape == b.shape
        assert float((a - b).abs().max()) <= K1_TOL


@pytest.mark.parametrize("G", [12, 14, 23, 24])
def test_extract_windows_kernel_bit_exact(cuda, G):
    from coslam_torch.ops.patches import (extract_windows,
                                          extract_windows_plain)
    g = torch.Generator().manual_seed(G)
    for (C, h, w, n) in [(1, 480, 640, 1024), (2, 60, 80, 37)]:
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
    from coslam_torch.ops.patches import extract_windows
    from coslam_torch.ops.pyramid import pyramid_level
    img = torch.rand((1, 64, 80), device=cuda) * 255
    base = torch.zeros((1, 8, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pyramid_level(img.double(), True)
    with pytest.raises(ValueError):
        pyramid_level(img.transpose(1, 2), True)
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
    from coslam_torch.ops.patches import extract_windows
    from coslam_torch.ops.pyramid import pyramid_level
    from coslam_torch.slam.pipeline import CoSlamEngine
    planes = make_room(np.random.default_rng(0), size=10.0)
    Rs, ts = orbit_trajectory(30, forward=0.06)
    frames = render_sequence(planes, tp.KMAT[0], Rs, ts, tp.H, tp.W,
                             device="cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        n1, n2 = pyramid_level.launches, extract_windows.launches
        eng = CoSlamEngine(small_test_config(1, tp.H, tp.W), tp.KMAT, tp.KC,
                           device=dev)
        for f in range(30):
            eng.process_frame(frames[f][None].to(dev))
        launched = (pyramid_level.launches - n1, extract_windows.launches - n2)
        runs[dev] = (eng, launched)
    (cpu, l_cpu), (gpu, l_gpu) = runs["cpu"], runs["cuda"]
    assert l_cpu == (0, 0)
    assert l_gpu[0] == 30 * 3 and l_gpu[1] > 0
    assert tp.boot_frame(gpu.stats_log) == tp.boot_frame(cpu.stats_log)
    assert len(set(gpu.kf_frames) ^ set(cpu.kf_frames)) <= 2
    for eng in (cpu, gpu):
        assert ate_rmse(*eng.trajectory(0, True), Rs, ts) < 0.20
