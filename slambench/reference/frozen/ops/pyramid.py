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
from torch.profiler import record_function

from slambench.reference.frozen.ops.image import (downsample2, gaussian_blur,
                                    sobel_derivatives)

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


def build_pyramid(img: torch.Tensor, n_levels: int) -> Pyramid:
    """img: [C, H, W] f32 grayscale (0..255 scale). Returns n_levels
    levels; level 0 is the blurred full-res image. A CUDA tensor launches
    the kernel once (or raises); a CPU tensor takes the plain twin."""
    with record_function("build_pyramid"):
        img = img.contiguous()
        return build_pyramid_plain(img, n_levels)


build_pyramid.launches = 0   # kernel launches (CUDA tensors only)
