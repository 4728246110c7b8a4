"""Batched coarse-to-fine KLT feature tracker with per-feature gain (the
port of ``coslam_tpu/ops/klt.py``).

Inverse-compositional Gauss-Newton on pure translation: per level, an
integer-aligned template window and a target window around each feature;
each iteration resamples the [S, S] patch at the current estimate with one
shared bilinear fraction. Illumination gain is solved in closed form per
iteration: g* = (sum I*T + lam) / (sum I*I + lam).

``klt_track`` tracks every feature of every camera through every level in
one launch of the CUDA kernel ``csrc/klt_track.cu`` for CUDA tensors (one
warp per feature, windows in shared memory, the Gauss-Newton loop on chip,
each feature leaving it once done; window radii above 7 take the kernel's
general path); CPU tensors take the plain twin
``klt_track_plain``, which cuts its windows with ``extract_windows`` and
runs the array code below.

Departures of the plain twin from the JAX formulation, same results: the
TPU-only shift chains of ``_int_subwindow`` become an indexed select, and
the early-exit ``while_loop`` becomes a fixed ``n_iterations`` loop —
finished features are already masked out of every update (``step_ok``),
so the extra iterations change nothing and no host sync is needed per
iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coslam_torch.config import KLTConfig
from coslam_torch.ops import cuda_lib
from coslam_torch.ops.patches import clamp_origins, extract_windows, frac_shift
from coslam_torch.ops.pyramid import MAX_LEVELS, Pyramid
from coslam_torch.spans import span

# search margin per level (px): integer displacement handled inside one
# window without re-extraction
_MARGIN = 6
# the largest window radius of the kernel's tuned path
# (csrc/klt_track.cu, MAX_RADIUS); larger radii launch its general kernel.
# A copy of the source's limit, read by the general-launch count only:
# chip_smoke.py's route checks hold that count against the kernel name a
# trace shows, so a change to either side that the other misses fails
# there.
TUNED_MAX_RADIUS = 7


class KLTResult(NamedTuple):
    pos: torch.Tensor     # [C, N, 2] tracked positions (full-res px)
    valid: torch.Tensor   # [C, N] bool
    ssd: torch.Tensor     # [C, N] final sum of squared differences
    gain: torch.Tensor    # [C, N] illumination gain estimate


def _levels_schedule(n_levels: int, level_skip: int) -> list[int]:
    levels = list(range(n_levels - 1, -1, -max(level_skip, 1)))
    if levels[-1] != 0:
        levels.append(0)
    return levels


def _kept_levels(pyr: Pyramid, cfg: KLTConfig) -> list[int]:
    """The schedule's levels, coarse to fine, without those whose image is
    smaller than the search window (level 0 always stays)."""
    G = 2 * cfg.window_radius + 2 + 2 * _MARGIN
    return [lv for lv in _levels_schedule(len(pyr.imgs), cfg.level_skip)
            if min(pyr.imgs[lv].shape[1:]) >= G + 2 or lv == 0]


def _int_subwindow(Wnd: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                   S: int) -> torch.Tensor:
    """out[a, b, n] = Wnd[iy[n] + a, ix[n] + b, n] for a, b < S."""
    G, _, M = Wnd.shape
    ar = torch.arange(S, device=Wnd.device)
    rows = (iy.long()[None, :] + ar[:, None])            # [S, M]
    sub = torch.gather(Wnd, 0, rows[:, None, :].expand(S, G, M))
    cols = (ix.long()[None, None, :] + ar[None, :, None])  # [1, S, M]
    return torch.gather(sub, 1, cols.expand(S, S, M))


def _track_level(img_t, img_c, pos_t, q, g, cfg: KLTConfig):
    """One pyramid level, all cameras flattened onto the feature axis.
    img_t/img_c: [C, h, w]; pos_t: [C*N, 2] template positions (level
    coords); q: [C*N, 2] current estimates. Returns (q, g, ok, ssd,
    iters), iters [C*N] being the iterations each feature ran before it
    was done."""
    C, h, w = img_c.shape
    CN = q.shape[0]
    N = CN // C
    r = cfg.window_radius
    S = 2 * r + 1
    G = S + 1 + 2 * _MARGIN            # target window size
    GT = S + 3                         # template window (patch + grad + lerp)
    f32 = torch.float32
    dev = q.device

    # --- template: T [S,S,CN], gradients, fixed Hessian ---
    bt = clamp_origins(torch.floor(pos_t - r).to(torch.int32) - 1, w - GT,
                       h - GT)
    Wt = extract_windows(img_t, bt.reshape(C, N, 2).contiguous(),
                         GT).reshape(GT, GT, CN)
    ft = pos_t - r - 1 - bt.to(f32)
    ftx = torch.clamp(ft[:, 0], 0.0, 1.0)[None, None, :]
    fty = torch.clamp(ft[:, 1], 0.0, 1.0)[None, None, :]
    Tbig = frac_shift(Wt, ftx, fty)                 # [S+2, S+2, CN]
    T = Tbig[1:S + 1, 1:S + 1]
    Tx = 0.5 * (Tbig[1:S + 1, 2:] - Tbig[1:S + 1, :S])
    Ty = 0.5 * (Tbig[2:, 1:S + 1] - Tbig[:S, 1:S + 1])
    H11 = torch.sum(Tx * Tx, (0, 1)) + 1e-4
    H12 = torch.sum(Tx * Ty, (0, 1))
    H22 = torch.sum(Ty * Ty, (0, 1)) + 1e-4
    det = H11 * H22 - H12 * H12
    det = torch.where(torch.abs(det) < 1e-8, torch.full_like(det, 1e-8), det)

    # --- target window around the level-start estimate ---
    b = clamp_origins(torch.floor(q - r).to(torch.int32) - _MARGIN, w - G,
                      h - G)
    Wc = extract_windows(img_c, b.reshape(C, N, 2).contiguous(),
                         G).reshape(G, G, CN)
    bf = b.to(f32)
    lam = cfg.gain_lambda
    top = G - S - 2

    def resample(q):
        s_pos = q - r - bf                          # support origin in window
        i = torch.floor(s_pos).to(torch.int32)
        in_range = (i[:, 0] >= 0) & (i[:, 0] <= top) & \
                   (i[:, 1] >= 0) & (i[:, 1] <= top)
        ic = torch.clamp(i, 0, top)
        f = s_pos - i.to(f32)
        sub = _int_subwindow(Wc, ic[:, 0], ic[:, 1], S + 1)
        I = frac_shift(sub, f[:, 0][None, None, :], f[:, 1][None, None, :])
        return I, in_range

    done = torch.zeros((CN,), dtype=torch.bool, device=dev)
    iters = torch.zeros((CN,), dtype=torch.int32, device=dev)
    for _ in range(cfg.n_iterations):
        iters += ~done
        I, in_range = resample(q)
        if cfg.track_with_gain:
            g_new = (torch.sum(I * T, (0, 1)) + lam) / \
                    (torch.sum(I * I, (0, 1)) + lam)
        else:
            g_new = torch.ones_like(g)
        e = T - g_new[None, None, :] * I
        bx = torch.sum(Tx * e, (0, 1))
        by = torch.sum(Ty * e, (0, 1))
        du = (H22 * bx - H12 * by) / det
        dv = (H11 * by - H12 * bx) / det
        step_ok = in_range & torch.isfinite(du) & torch.isfinite(dv) & ~done
        q = q + torch.where(step_ok[:, None], torch.stack([du, dv], -1),
                            torch.zeros_like(q))
        g = torch.where(step_ok, g_new, g)
        done = done | (torch.hypot(du, dv) < cfg.convergence_threshold) \
            | ~in_range
    # in-search-range check for validity + final residual for SSD
    I, ok = resample(q)
    e = T - g[None, None, :] * I
    ssd = torch.sum(e * e, (0, 1))
    return q, g, ok, ssd, iters


def klt_track_plain(pyr_prev: Pyramid, pyr_cur: Pyramid, pos: torch.Tensor,
                    valid: torch.Tensor, cfg: KLTConfig) -> KLTResult:
    """The plain PyTorch tracker (see ``klt_track``)."""
    C, N = pos.shape[:2]
    levels = _kept_levels(pyr_cur, cfg)
    top = levels[0]
    pos_f = pos.reshape(C * N, 2)
    q = pos_f * (0.5 ** top)
    g = torch.ones(C * N, dtype=pos.dtype, device=pos.device)
    ok = valid.reshape(C * N)
    prev_l = top
    ssd = torch.zeros(C * N, dtype=pos.dtype, device=pos.device)
    for li, lv in enumerate(levels):
        if li > 0:
            q = q * (2.0 ** (prev_l - lv))
        pos_t = pos_f * (0.5 ** lv)
        q, g, ok_l, ssd, _ = _track_level(
            pyr_prev.imgs[lv], pyr_cur.imgs[lv], pos_t, q, g, cfg)
        # only the finest level's search-range check gates validity
        if lv == 0:
            ok = ok & ok_l
        prev_l = lv
    h, w = pyr_cur.imgs[0].shape[1:]
    bdr = float(cfg.border)
    in_border = ((q[:, 0] >= bdr) & (q[:, 0] <= w - 1 - bdr)
                 & (q[:, 1] >= bdr) & (q[:, 1] <= h - 1 - bdr))
    ok = ok & in_border & (ssd < cfg.ssd_threshold) & \
        torch.all(torch.isfinite(q), -1)
    return KLTResult(pos=q.reshape(C, N, 2), valid=ok.reshape(C, N),
                     ssd=ssd.reshape(C, N), gain=g.reshape(C, N))


def _klt_track_cuda(pyr_prev: Pyramid, pyr_cur: Pyramid, pos: torch.Tensor,
                    valid: torch.Tensor, cfg: KLTConfig) -> KLTResult:
    if pos.dtype != torch.float32 or pos.dim() != 3 or pos.shape[2] != 2:
        raise ValueError(f"klt_track takes pos [C, N, 2] float32, got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    C, N = pos.shape[:2]
    if valid.dtype != torch.bool or tuple(valid.shape) != (C, N):
        raise ValueError(f"klt_track takes valid [C, N] bool, got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if valid.device != pos.device:
        raise ValueError("klt_track: pos and valid on different devices")
    n_levels = len(pyr_prev.imgs)
    if len(pyr_cur.imgs) != n_levels or not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError("klt_track takes two pyramids of 1 to "
                         f"{MAX_LEVELS} levels each, got "
                         f"{len(pyr_prev.imgs)} and {len(pyr_cur.imgs)}")
    H, W = pyr_cur.imgs[0].shape[1:]
    for lv in range(n_levels):
        for im in (pyr_prev.imgs[lv], pyr_cur.imgs[lv]):
            if im.dtype != torch.float32 or \
                    tuple(im.shape) != (C, H >> lv, W >> lv) or \
                    not im.is_contiguous() or im.device != pos.device:
                raise ValueError(
                    f"klt_track: level {lv} must be a contiguous float32 "
                    f"[{C}, {H >> lv}, {W >> lv}] on {pos.device}, got "
                    f"{im.dtype} {tuple(im.shape)} on {im.device}")
    r = cfg.window_radius
    if r < 0:
        raise ValueError(f"klt_track: window_radius {r} is negative")
    G = 2 * r + 2 + 2 * _MARGIN
    if min(H, W) < G:
        raise ValueError(f"klt_track: a {H}x{W} image is smaller than the "
                         f"{G}-px search window")
    pos = pos.contiguous()
    valid = valid.contiguous()
    pos_out = torch.empty_like(pos)
    valid_out = torch.empty_like(valid)
    ssd = torch.empty((C, N), dtype=pos.dtype, device=pos.device)
    gain = torch.empty((C, N), dtype=pos.dtype, device=pos.device)
    if C * N == 0:
        return KLTResult(pos=pos_out, valid=valid_out, ssd=ssd, gain=gain)
    levels = _kept_levels(pyr_cur, cfg)
    prev = cuda_lib.pointer_array([t.data_ptr() for t in pyr_prev.imgs])
    cur = cuda_lib.pointer_array([t.data_ptr() for t in pyr_cur.imgs])
    fn = cuda_lib.library("klt_track").klt_track
    with torch.cuda.device(pos.device):
        rc = fn(prev, cur, cuda_lib.int_array(levels), len(levels),
                pos.data_ptr(), valid.data_ptr(), pos_out.data_ptr(),
                valid_out.data_ptr(), ssd.data_ptr(), gain.data_ptr(),
                C, N, H, W, r, cfg.n_iterations, int(cfg.track_with_gain),
                cfg.gain_lambda, cfg.convergence_threshold,
                float(cfg.border), cfg.ssd_threshold,
                torch.cuda.current_stream().cuda_stream)
    cuda_lib.check("klt_track", rc)
    klt_track.launches += 1
    klt_track.general_launches += r > TUNED_MAX_RADIUS
    return KLTResult(pos=pos_out, valid=valid_out, ssd=ssd, gain=gain)


def klt_track(pyr_prev: Pyramid, pyr_cur: Pyramid, pos: torch.Tensor,
              valid: torch.Tensor, cfg: KLTConfig) -> KLTResult:
    """Track features from the previous to the current frame, all cameras.
    pyr_*: camera-batched pyramids; pos: [C, N, 2]; valid: [C, N]. Every
    slot is tracked, valid or not. CUDA tensors launch the kernel once (or
    raise); CPU tensors take the plain twin."""
    with span("klt_track"):
        if pos.is_cuda:
            return _klt_track_cuda(pyr_prev, pyr_cur, pos, valid, cfg)
        return klt_track_plain(pyr_prev, pyr_cur, pos, valid, cfg)


klt_track.launches = 0   # kernel launches (CUDA tensors only)
klt_track.general_launches = 0   # of them, launches of the general kernel
