"""NCC appearance blocks (the port of the parts of ``coslam_tpu/ops/ncc.py``
the monocular path runs: block extraction and normalization; score
matrices and the template search wait for the multi-camera and
loop-closure slices).

Blocks are stored pre-normalized (zero mean, unit norm), so an NCC score
is one dot product.
"""

from __future__ import annotations

import torch

from coslam_torch.ops.patches import extract_windows, frac_shift


def _normalize_blocks(raw, pos, h, w, radius):
    """raw: [..., S*S]; pos: [..., 2]. Zero-mean unit-norm blocks + valid."""
    ok = ((pos[..., 0] >= radius) & (pos[..., 1] >= radius)
          & (pos[..., 0] <= w - 1.001 - radius)
          & (pos[..., 1] <= h - 1.001 - radius))
    mean = torch.mean(raw, dim=-1, keepdim=True)
    cen = raw - mean
    norm = torch.linalg.norm(cen, dim=-1, keepdim=True)
    blocks = cen / torch.clamp(norm, min=1e-6)
    ok = ok & (norm[..., 0] > 1e-3)   # reject textureless patches
    blocks = torch.where(ok[..., None], blocks, torch.zeros_like(blocks))
    return blocks, ok


def extract_ncc_blocks_batched(imgs: torch.Tensor, pos: torch.Tensor,
                               radius: int = 5):
    """All cameras at once: imgs [C, H, W], pos [C, N, 2]. Returns
    (blocks [C, N, (2r+1)^2] normalized, valid [C, N])."""
    C, h, w = imgs.shape
    S = 2 * radius + 1
    lim = torch.tensor([w - S - 1, h - S - 1], dtype=torch.int32,
                       device=pos.device)
    base = torch.floor(pos - radius).to(torch.int32)
    basec = torch.clamp(base, min=torch.zeros_like(lim), max=lim)
    Wnd = extract_windows(imgs, basec.contiguous(), S + 1)  # [S+1,S+1,C,N]
    f = pos - radius - basec.to(pos.dtype)
    fx = torch.clamp(f[..., 0], 0.0, 1.0)[None, None]
    fy = torch.clamp(f[..., 1], 0.0, 1.0)[None, None]
    raw = frac_shift(Wnd, fx, fy)                            # [S, S, C, N]
    raw = raw.reshape(S * S, C, -1).permute(1, 2, 0)         # [C, N, S*S]
    return _normalize_blocks(raw, pos, h, w, radius)
