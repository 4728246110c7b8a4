"""The kernels' roofline counts against the bytes and operations that
PERF.md's kernel table lists for chip_smoke.py's kernel phase (three
cameras, 480x640, 4 levels, N = 1024)."""

import numpy as np
import torch

from slambench.reference.frozen.config import KLTConfig
from slambench.reference.frozen.ops.corners import detect_corners
from slambench.reference.frozen.ops.pyramid import build_pyramid
from slambench.roofline import build_pyramid as pyramid_count
from slambench.roofline import klt_track as klt_count
from slambench.scene import (MovingQuad, _render, make_room, make_texture,
                             rig_poses)

H, W, N = 480, 640, 1024
CFG3 = {"num_cameras": 3, "image_height": H, "image_width": W,
        "klt": {"n_levels": 4}}


def test_build_pyramid_count_at_three_cameras():
    nbytes, flop = pyramid_count.work(CFG3, [])
    assert nbytes == 15_955_200            # bound 0.0047627 ms at 3.35 TB/s
    px = [3 * (H >> lv) * (W >> lv) for lv in range(4)]
    assert flop == sum(p * 18 for p in px) + px[0] * 20 + sum(px[1:]) * 4
    assert nbytes / 3.35e12 > flop / 67e12    # bound by bytes


def kernel_phase_frames():
    """chip_smoke.py's threecam scene from seed 0, frames 0 and 2, drawn
    and rendered as there (view by view, rounded to float16)."""
    rng = np.random.default_rng(0)
    quad = MovingQuad(center0=np.array([-3.0, 0.5, 14.0], np.float32),
                      velocity=np.array([0.012, 0.0, 0.0], np.float32),
                      eu=np.array([1.6, 0, 0], np.float32),
                      ev=np.array([0, 1.6, 0], np.float32),
                      tex=make_texture(rng))
    rng.uniform()
    planes = make_room(rng, size=10.0)
    Rs, ts = rig_poses(3, 3, 1.0, {})
    K = torch.tensor([[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1]])
    allp = planes + [planes[0]._replace(
        p0=quad.center0 - 0.5 * quad.eu - 0.5 * quad.ev, eu=quad.eu,
        ev=quad.ev, tex=quad.tex)]

    def f(a):
        return torch.as_tensor(np.stack(a).astype(np.float32))

    p0, eu, ev, tex = (f([p.p0 for p in allp]), f([p.eu for p in allp]),
                       f([p.ev for p in allp]), f([p.tex for p in allp]))
    vel = torch.as_tensor(quad.velocity)
    out = []
    for fr in (0, 2):
        p0f = torch.cat([p0[:-1], p0[-1:] + float(fr) * vel])
        out.append(torch.stack([
            _render(p0f, eu, ev, tex, K, torch.as_tensor(Rs[fr, c]),
                    torch.as_tensor(ts[fr, c]), H, W) for c in range(3)]))
    return [o.half().float() for o in out]


def test_klt_count_on_the_kernel_phase_inputs():
    f0, f2 = kernel_phase_frames()
    pyr0, pyr1 = build_pyramid(f0, 4), build_pyramid(f2, 4)
    cfg = KLTConfig(n_levels=4)
    det = detect_corners(pyr0.imgs[0], pyr0.dxs[0], pyr0.dys[0], cfg, N)
    pos = det.pos.clone()
    k = torch.arange(N)
    pos[0, k % 97 == 3] = torch.tensor([1.5, 3.0])
    pos[0, k % 97 == 5] = torch.tensor([W - 4.5, H - 9.25])
    pos[0, 11] = float("nan")
    nbytes, flop, n_it = klt_count.klt_work(pyr0, pyr1, pos, cfg)
    assert nbytes == 6_084_612
    assert flop == 121 * (17 * n_it + 31 * 4 * 3 * N)
    # the card's plain tracker ran 14,694 Gauss-Newton iterations on these
    # inputs (76,317,846 flop), the CPU's ~0.3% fewer: convergence exits
    # differ with the rounding
    assert abs(flop - 76_317_846) < 0.002 * 76_317_846
