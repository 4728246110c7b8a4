"""Bytes and operations one ``klt_track`` call needs on its inputs (the
arithmetic of chip_smoke.py's kernel phase): the distinct pixels its
template and target windows cover on every kept level (the plain
tracker's level loop, replayed to find each level's target origins),
the inputs and the outputs; ~17 flop per patch pixel per Gauss-Newton
iteration this data runs (resample 7, gain 4, residual 2, gradient sums
4) and ~31 per patch pixel per level (shifted template, gradients,
Hessian, final residual). Every slot of the track table is tracked,
valid or not, as the kernel does."""

import torch


def covered_pixels(h: int, w: int, C: int, base, G: int, dev) -> int:
    """Distinct pixels of a [C, h, w] image that G x G windows at the
    origins base [C, N, 2] (clamped, as every window kernel does) cover."""
    cover = torch.zeros((C, h, w), dtype=torch.bool, device=dev)
    x0 = base[..., 0].long().clamp(0, w - G)
    y0 = base[..., 1].long().clamp(0, h - G)
    g = torch.arange(G, device=dev)
    cam = torch.arange(C, device=dev)[:, None, None, None]
    cover[cam, (y0[..., None, None] + g[:, None]),
          (x0[..., None, None] + g[None, :])] = True
    return int(cover.sum())


def klt_work(pyr_prev, pyr_cur, pos, cfg):
    """(bytes, flop, Gauss-Newton iterations) of one call: pyramids of the
    frozen plain path, pos [C, N, 2], cfg a frozen KLTConfig."""
    from slambench.reference.frozen.ops.klt import (_MARGIN, _kept_levels,
                                                    _track_level)
    r = cfg.window_radius
    S = 2 * r + 1
    G, GT = S + 1 + 2 * _MARGIN, S + 3
    C, N = pos.shape[:2]
    dev = pos.device
    # a NaN slot's window origin converts to 0 on the card: the same here
    pos_f = torch.nan_to_num(pos.reshape(C * N, 2), nan=0.0)
    levels = _kept_levels(pyr_cur, cfg)
    q = pos_f * (0.5 ** levels[0])
    g = torch.ones(C * N, device=dev)
    px, n_it, prev = 0, 0, levels[0]
    for li, lv in enumerate(levels):
        if li > 0:
            q = q * (2.0 ** (prev - lv))
        h, w = pyr_cur.imgs[lv].shape[1:]
        pos_t = pos_f * (0.5 ** lv)
        bt = torch.floor(pos_t - r).to(torch.int32) - 1
        b = torch.floor(q - r).to(torch.int32) - _MARGIN
        px += covered_pixels(h, w, C, bt.reshape(C, N, 2), GT, dev)
        px += covered_pixels(h, w, C, b.reshape(C, N, 2), G, dev)
        q, g, _, _, it = _track_level(pyr_prev.imgs[lv], pyr_cur.imgs[lv],
                                      pos_t, q, g, cfg)
        n_it += int(it.sum())
        prev = lv
    # inputs pos (8 B) + valid (1 B); outputs pos, valid, ssd, gain
    nbytes = px * 4 + C * N * (8 + 1) + C * N * (8 + 1 + 4 + 4)
    flop = S * S * (17 * n_it + 31 * len(levels) * C * N)
    return nbytes, flop, n_it


def work(cfg: dict, samples) -> tuple[float, float] | None:
    """Mean (bytes, flop) a call over ``samples``: the traced calls'
    inputs, each {"prev", "cur": uint8 [C, H, W] images, "state": the
    engine's state before the call}."""
    from slambench.check import frozen_config
    from slambench.reference.frozen.ops.pyramid import build_pyramid
    if not samples:
        return None
    fc = frozen_config(cfg)
    tot_b = tot_f = 0.0
    for s in samples:
        pos = s["state"].tracks.pos
        dev = pos.device
        pyrs = [build_pyramid(torch.as_tensor(s[k]).to(dev, torch.float32),
                              fc.klt.n_levels) for k in ("prev", "cur")]
        nb, fl, _ = klt_work(pyrs[0], pyrs[1], pos, fc.klt)
        tot_b += nb
        tot_f += fl
    return tot_b / len(samples), tot_f / len(samples)
