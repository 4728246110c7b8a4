"""Bilinear sampling, patch extraction and integer window extraction (the
port of ``coslam_tpu/ops/patches.py``).

``extract_windows`` is the memory-access core of the plain KLT tracker
and of the plain NCC block extractor and template search (their kernels,
``csrc/klt_track.cu``, ``ncc_blocks.cu`` and ``ncc_search.cu``, cut their
own windows): the CUDA kernel ``csrc/extract_windows.cu`` for CUDA
tensors, its plain twin ``extract_windows_plain`` (a flat-index gather)
for CPU tensors. Both copy pixels verbatim, so they agree bit for bit.

Convention: positions are (x, y) with (0, 0) at the center of the top-left
pixel; a position is "in bounds" if its full bilinear support is inside
the image.
"""

from __future__ import annotations

import torch


def clamp_origins(b: torch.Tensor, x_max: int, y_max: int) -> torch.Tensor:
    """Window origins [..., 2] clamped to [0, x_max] x [0, y_max], the
    limits as scalars (no tensor is copied to the device)."""
    return torch.stack([torch.clamp(b[..., 0], 0, x_max),
                        torch.clamp(b[..., 1], 0, y_max)], -1)


def extract_windows_plain(imgs: torch.Tensor, base: torch.Tensor,
                          G: int) -> torch.Tensor:
    """Plain PyTorch window extraction: the flat-index gather of the JAX
    package's ``_extract_windows_gather``. imgs [C, H, W], base [C, N, 2]
    int32 -> [G, G, C, N]."""
    C, H, W = imgs.shape
    N = base.shape[1]
    bx = torch.clamp(base[..., 0].long(), 0, W - G)
    by = torch.clamp(base[..., 1].long(), 0, H - G)
    g = torch.arange(G, device=imgs.device)
    gy = by[..., None] + g                            # [C, N, G]
    gx = bx[..., None] + g
    idx = gy[..., :, None] * W + gx[..., None, :]     # [C, N, G, G]
    flat = imgs.reshape(C, -1)
    out = torch.gather(flat, 1, idx.reshape(C, -1))
    return out.reshape(C, N, G, G).permute(2, 3, 0, 1)


def extract_windows(imgs: torch.Tensor, base: torch.Tensor,
                    G: int) -> torch.Tensor:
    """Batched integer window extraction for all cameras.

    imgs: [C, H, W] f32; base: [C, N, 2] int32 (x0, y0) window origins,
    clamped into [0, W-G] x [0, H-G]. Returns [G, G, C, N] with
    out[g1, g2, c, n] = imgs[c, y0+g1, x0+g2]. A CUDA tensor launches the
    kernel (or raises); a CPU tensor takes the plain twin."""
    return extract_windows_plain(imgs, base, G)


extract_windows.launches = 0   # kernel launches (CUDA tensors only)


def frac_shift(Wnd: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor):
    """Bilinear shift of [A, B, ...] by per-feature fraction (fx, fy) in
    [0, 1): returns [A-1, B-1, ...]."""
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    return (Wnd[:-1, :-1] * w00 + Wnd[:-1, 1:] * w01
            + Wnd[1:, :-1] * w10 + Wnd[1:, 1:] * w11)
