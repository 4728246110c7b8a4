"""Shared image filtering helpers (separable filters, box filters, pooling)
on batched images [C, H, W] f32 — the port of ``coslam_tpu/ops/image.py``.

Every separable pass edge-replicates ITS OWN input (``_conv1d`` reads the
input at clamped coordinates), and sums its taps in order, one multiply
and one add at a time. The pyramid kernel (csrc/build_pyramid.cu) follows
the same convention and order, so it agrees with these filters over the
whole image, border frame included.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _clamped(n: int, k: int, device) -> torch.Tensor:
    """[k, n] source indices of the k taps of a SAME edge-replicate pass."""
    pad = k // 2
    i = torch.arange(n, device=device)
    return torch.stack([torch.clamp(i + j - pad, 0, n - 1) for j in range(k)])


def _conv1d(img: torch.Tensor, kernel, axis: int) -> torch.Tensor:
    """Depthwise 1-D filter along H (axis=1) or W (axis=2) with SAME
    edge-replicate padding, as a shift-and-accumulate. kernel: floats."""
    idx = _clamped(img.shape[axis], len(kernel), img.device)
    out = None
    for j, kj in enumerate(kernel):
        term = torch.index_select(img, axis, idx[j]) * kj
        out = term if out is None else out + term
    return out


def separable_filter(img: torch.Tensor, kh, kw) -> torch.Tensor:
    return _conv1d(_conv1d(img, kh, axis=1), kw, axis=2)


BLUR5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
DERIV3 = (-0.5, 0.0, 0.5)
SMOOTH3 = (0.25, 0.5, 0.25)


def gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    """5-tap binomial blur (the classic pyramid smoother)."""
    return separable_filter(img, BLUR5, BLUR5)


def sobel_derivatives(img: torch.Tensor):
    """Central-difference x/y derivatives with binomial cross-smoothing."""
    dx = _conv1d(_conv1d(img, DERIV3, axis=2), SMOOTH3, axis=1)
    dy = _conv1d(_conv1d(img, DERIV3, axis=1), SMOOTH3, axis=2)
    return dx, dy


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average downsample (scaleDownAvg): ((a + b) + c + d) * 0.25 over
    each 2x2 block in row-major window order, as XLA's reduce_window
    accumulates; odd trailing rows/columns dropped."""
    c, h, w = img.shape
    x = img[:, : (h // 2) * 2, : (w // 2) * 2]
    s = x[:, 0::2, 0::2] + x[:, 0::2, 1::2] + x[:, 1::2, 0::2] \
        + x[:, 1::2, 1::2]
    return s * 0.25


def box_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Sum over a (2r+1)^2 window (structure-tensor accumulation)."""
    k = (1.0,) * (2 * radius + 1)
    return separable_filter(img, k, k)


def max_pool_same(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Max over a (2r+1)^2 window, SAME size; out-of-image taps are -inf."""
    k = 2 * radius + 1
    return F.max_pool2d(img[None], kernel_size=k, stride=1,
                        padding=radius)[0]
