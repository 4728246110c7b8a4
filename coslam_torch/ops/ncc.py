"""NCC appearance blocks and dense score matrices (the port of
``coslam_tpu/ops/ncc.py``; the template search ``ncc_search`` waits for
loop closure).

Blocks are stored pre-normalized (zero mean, unit norm), so an NCC score
is one dot product and an A x B score matrix one matrix product.

The JAX package cuts the windows of one image's blocks with bf16 hi/lo
one-hot matrix products (``extract_windows_onehot``, a TPU formulation
accurate to ~2^-16 relative); here every block goes through
``ops/patches.py::extract_windows`` (the window kernel on the card), which
copies pixels exactly.
"""

from __future__ import annotations

import torch

from coslam_torch.ops.patches import extract_windows, frac_shift

NCC_INVALID = -2.0


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


def extract_ncc_blocks(img: torch.Tensor, pos: torch.Tensor, radius: int = 5):
    """One image: img [H, W], pos [N, 2]. Returns (blocks [N, (2r+1)^2]
    normalized, valid [N]); invalid blocks are zeroed (NCC 0)."""
    blocks, ok = extract_ncc_blocks_batched(img[None], pos[None], radius)
    return blocks[0], ok[0]


def ncc_score_matrix(blocks_a: torch.Tensor, blocks_b: torch.Tensor,
                     valid_a: torch.Tensor, valid_b: torch.Tensor):
    """[A, S] x [B, S] -> [A, B] NCC scores; invalid rows/cols are
    NCC_INVALID."""
    s = blocks_a @ blocks_b.T
    bad = ~(valid_a[:, None] & valid_b[None, :])
    return torch.where(bad, torch.full_like(s, NCC_INVALID), s)

