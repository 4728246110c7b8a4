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

import numpy as np
import torch

from coslam_torch.ops import cuda_lib


def sample_bilinear(img: torch.Tensor, pts: torch.Tensor):
    """img: [H, W]; pts: [..., 2] (x, y). Returns (vals [...], valid [...]).
    Out-of-bounds samples are clamped; validity marks full in-bounds
    support."""
    h, w = img.shape
    x = pts[..., 0]
    y = pts[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 2)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 2)
    flat = img.reshape(-1)
    base = y0i * w + x0i
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + w]
    v11 = flat[base + w + 1]
    vals = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)
    valid = (x >= 0) & (y >= 0) & (x <= w - 1.001) & (y <= h - 1.001)
    return vals, valid


def clamp_origins(b: torch.Tensor, x_max: int, y_max: int) -> torch.Tensor:
    """Window origins [..., 2] clamped to [0, x_max] x [0, y_max], the
    limits as scalars (no tensor is copied to the device)."""
    return torch.stack([torch.clamp(b[..., 0], 0, x_max),
                        torch.clamp(b[..., 1], 0, y_max)], -1)


def patch_offsets(radius: int, dtype=torch.float32, device=None):
    """[(2r+1)^2, 2] (dx, dy) offsets, row-major."""
    r = radius
    g = np.mgrid[-r:r + 1, -r:r + 1]  # [2, k, k] (dy, dx)
    off = np.stack([g[1].ravel(), g[0].ravel()], axis=-1)
    return torch.as_tensor(off, dtype=dtype, device=device)


def extract_patches(img: torch.Tensor, centers: torch.Tensor, radius: int):
    """img: [H, W]; centers: [N, 2]. Returns (patches [N, (2r+1)^2],
    valid [N]) — valid requires the whole patch support in bounds."""
    off = patch_offsets(radius, centers.dtype, centers.device)
    pts = centers[:, None, :] + off[None, :, :]
    vals, ok = sample_bilinear(img, pts)
    return vals, torch.all(ok, dim=-1)


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


def _extract_windows_cuda(imgs: torch.Tensor, base: torch.Tensor,
                          G: int) -> torch.Tensor:
    if imgs.dtype != torch.float32 or imgs.dim() != 3:
        raise ValueError(f"extract_windows takes imgs [C, H, W] float32, got "
                         f"{imgs.dtype} {tuple(imgs.shape)}")
    C, H, W = imgs.shape
    if base.dtype != torch.int32 or base.dim() != 3 or \
            base.shape[0] != C or base.shape[2] != 2:
        raise ValueError(f"extract_windows takes base [C, N, 2] int32, got "
                         f"{base.dtype} {tuple(base.shape)}")
    if base.device != imgs.device:
        raise ValueError("extract_windows: imgs and base on different devices")
    if not (imgs.is_contiguous() and base.is_contiguous()):
        raise ValueError("extract_windows takes contiguous tensors")
    if not 0 < G <= min(H, W):
        raise ValueError(f"window size {G} does not fit a {H}x{W} image")
    N = base.shape[1]
    out = torch.empty((G, G, C, N), dtype=imgs.dtype, device=imgs.device)
    if N == 0 or C == 0:
        return out
    fn = cuda_lib.library("extract_windows").extract_windows
    with torch.cuda.device(imgs.device):
        rc = fn(imgs.data_ptr(), base.data_ptr(), out.data_ptr(),
                C, H, W, N, G, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check("extract_windows", rc)
    extract_windows.launches += 1
    return out


def extract_windows(imgs: torch.Tensor, base: torch.Tensor,
                    G: int) -> torch.Tensor:
    """Batched integer window extraction for all cameras.

    imgs: [C, H, W] f32; base: [C, N, 2] int32 (x0, y0) window origins,
    clamped into [0, W-G] x [0, H-G]. Returns [G, G, C, N] with
    out[g1, g2, c, n] = imgs[c, y0+g1, x0+g2]. A CUDA tensor launches the
    kernel (or raises); a CPU tensor takes the plain twin."""
    if imgs.is_cuda:
        return _extract_windows_cuda(imgs, base, G)
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
