"""Gaussian image pyramid with level-0 x/y derivatives (the port of
``coslam_tpu/ops/pyramid.py`` and ``ops/pyramid_pallas.py``).

``build_pyramid`` builds every level in one launch of the CUDA kernel
``csrc/build_pyramid.cu`` for a CUDA tensor, and runs its plain PyTorch
twin ``build_pyramid_plain`` (``pyramid_level_plain`` per level, the
``ops/image.py`` filters, with ``downsample2`` between levels) for a CPU
tensor. The two agree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coslam_torch.ops import cuda_lib
from coslam_torch.ops.image import (downsample2, gaussian_blur,
                                    sobel_derivatives)
from coslam_torch.spans import span

MAX_LEVELS = 16   # csrc/build_pyramid.cu's level table


class Pyramid(NamedTuple):
    """imgs: tuple (len = n_levels) of [C, H/2^l, W/2^l] blurred levels.
    dxs/dys: length-1 tuples — derivatives at level 0 only (the corner
    detector is their only consumer; KLT differentiates its own windows)."""

    imgs: tuple
    dxs: tuple
    dys: tuple

    @property
    def n_levels(self) -> int:
        return len(self.imgs)


def pyramid_level_plain(img: torch.Tensor, derivs: bool = True):
    """One plain PyTorch pyramid level: img [C, H, W] f32 -> sm, or
    (sm, dx, dy) with ``derivs``."""
    sm = gaussian_blur(img)
    if not derivs:
        return sm
    dx, dy = sobel_derivatives(sm)
    return sm, dx, dy


def build_pyramid_plain(img: torch.Tensor, n_levels: int) -> Pyramid:
    """The plain PyTorch pyramid: level 0 with its derivatives, then the
    blur of the 2x2 average of each level for the next."""
    imgs = []
    cur = img
    dx0 = dy0 = None
    for lvl in range(n_levels):
        if lvl == 0:
            sm, dx0, dy0 = pyramid_level_plain(cur, True)
        else:
            sm = pyramid_level_plain(cur, False)
        imgs.append(sm)
        if lvl + 1 < n_levels:
            cur = downsample2(sm)
    return Pyramid(imgs=tuple(imgs), dxs=(dx0,), dys=(dy0,))


def _build_pyramid_cuda(img: torch.Tensor, n_levels: int) -> Pyramid:
    if img.dtype != torch.float32 or img.dim() != 3:
        raise ValueError(f"build_pyramid takes [C, H, W] float32, got "
                         f"{img.dtype} {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("build_pyramid takes a contiguous image batch")
    C, H, W = img.shape
    if not 1 <= n_levels <= MAX_LEVELS or C < 1 or \
            min(H, W) >> (n_levels - 1) < 1:
        raise ValueError(f"build_pyramid: {n_levels} levels do not fit a "
                         f"{C}x{H}x{W} batch")
    sms = [torch.empty((C, H >> lv, W >> lv), dtype=img.dtype,
                       device=img.device) for lv in range(n_levels)]
    dx = torch.empty_like(img)
    dy = torch.empty_like(img)
    ptrs = cuda_lib.pointer_array([t.data_ptr() for t in sms])
    fn = cuda_lib.library("build_pyramid").build_pyramid
    with torch.cuda.device(img.device):
        rc = fn(img.data_ptr(), dx.data_ptr(), dy.data_ptr(), ptrs,
                C, H, W, n_levels, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check("build_pyramid", rc)
    build_pyramid.launches += 1
    return Pyramid(imgs=tuple(sms), dxs=(dx,), dys=(dy,))


def build_pyramid(img: torch.Tensor, n_levels: int) -> Pyramid:
    """img: [C, H, W] f32 grayscale (0..255 scale). Returns n_levels
    levels; level 0 is the blurred full-res image. A CUDA tensor launches
    the kernel once (or raises); a CPU tensor takes the plain twin."""
    with span("build_pyramid"):
        img = img.contiguous()
        if img.is_cuda:
            return _build_pyramid_cuda(img, n_levels)
        return build_pyramid_plain(img, n_levels)


build_pyramid.launches = 0   # kernel launches (CUDA tensors only)
