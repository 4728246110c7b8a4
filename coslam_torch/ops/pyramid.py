"""Gaussian image pyramid with level-0 x/y derivatives (the port of
``coslam_tpu/ops/pyramid.py`` and ``ops/pyramid_pallas.py``).

Each level is one call of ``pyramid_level``: the CUDA kernel
``csrc/pyramid_level.cu`` for a CUDA tensor, its plain PyTorch twin
``pyramid_level_plain`` (the ``ops/image.py`` filters) for a CPU tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coslam_torch.ops import cuda_lib
from coslam_torch.ops.image import (downsample2, gaussian_blur,
                                    sobel_derivatives)


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
    """Plain PyTorch pyramid level: img [C, H, W] f32 -> sm, or (sm, dx, dy)
    with ``derivs``."""
    sm = gaussian_blur(img)
    if not derivs:
        return sm
    dx, dy = sobel_derivatives(sm)
    return sm, dx, dy


def _pyramid_level_cuda(img: torch.Tensor, derivs: bool):
    if img.dtype != torch.float32 or img.dim() != 3:
        raise ValueError(f"pyramid_level takes [C, H, W] float32, got "
                         f"{img.dtype} {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("pyramid_level takes a contiguous image batch")
    C, H, W = img.shape
    sm = torch.empty_like(img)
    dx = torch.empty_like(img) if derivs else None
    dy = torch.empty_like(img) if derivs else None
    if img.numel() == 0:
        return (sm, dx, dy) if derivs else sm
    fn = cuda_lib.library("pyramid_level").pyramid_level
    with torch.cuda.device(img.device):
        rc = fn(img.data_ptr(), sm.data_ptr(),
                dx.data_ptr() if derivs else None,
                dy.data_ptr() if derivs else None,
                C, H, W, int(derivs), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check("pyramid_level", rc)
    pyramid_level.launches += 1
    return (sm, dx, dy) if derivs else sm


def pyramid_level(img: torch.Tensor, derivs: bool = True):
    """One pyramid level: the 5-tap binomial blur and, with ``derivs``, its
    derivative-of-Gaussian x/y gradients. img: [C, H, W] f32. A CUDA tensor
    launches the kernel (or raises); a CPU tensor takes the plain twin."""
    if img.is_cuda:
        return _pyramid_level_cuda(img, derivs)
    return pyramid_level_plain(img, derivs)


pyramid_level.launches = 0   # kernel launches (CUDA tensors only)


def build_pyramid(img: torch.Tensor, n_levels: int) -> Pyramid:
    """img: [C, H, W] f32 grayscale (0..255 scale). Returns n_levels
    levels; level 0 is the blurred full-res image."""
    imgs = []
    cur = img.contiguous()
    dx0 = dy0 = None
    for lvl in range(n_levels):
        if lvl == 0:
            sm, dx0, dy0 = pyramid_level(cur, True)
        else:
            sm = pyramid_level(cur, False)
        imgs.append(sm)
        if lvl + 1 < n_levels:
            cur = downsample2(sm).contiguous()
    return Pyramid(imgs=tuple(imgs), dxs=(dx0,), dys=(dy0,))
