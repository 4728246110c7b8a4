"""NCC appearance blocks, dense score matrices and the dense template
search (the port of ``coslam_tpu/ops/ncc.py``).

Blocks are stored pre-normalized (zero mean, unit norm), so an NCC score
is one dot product and an A x B score matrix one matrix product.

Two functions run as one CUDA kernel each on CUDA tensors:
``extract_ncc_blocks_batched`` (``csrc/ncc_blocks.cu``: every block cut,
shifted and normalized on chip) and ``ncc_search`` (``csrc/ncc_search.cu``:
a centre's whole search, window sums, correlation and arg-max, in one
thread block). Each kernel has a tuned path for patch radii up to 7 (and
search radii up to 20) and a general path for any larger radius. CPU
tensors take their plain versions, ``extract_ncc_blocks_batched_plain``
and ``ncc_search_plain``, which cut their windows with
``ops/patches.py::extract_windows`` (the window kernel, when they are
given CUDA tensors) and run the array code below.

The JAX package cuts the windows of one image's blocks with bf16 hi/lo
one-hot matrix products (``extract_windows_onehot``, a TPU formulation
accurate to ~2^-16 relative); here every block and every search window
comes from exact pixel copies.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from slambench.reference.frozen.ops.patches import clamp_origins, extract_windows, frac_shift

NCC_INVALID = -2.0
# the largest radii of the kernels' tuned paths (csrc/ncc_blocks.cu and
# csrc/ncc_search.cu, MAX_RADIUS and MAX_SEARCH); larger ones launch their
# general kernels. ncc_search.cu also sends a window of over 48 KB of
# shared memory there, which no radii within these need (45,964 B at 7
# and 20). Copies of the sources' limits, read by the general-launch
# counts only: chip_smoke.py's route checks hold those counts against the
# kernel names a trace shows, so a change to either side that the other
# misses fails there.
TUNED_MAX_RADIUS = 7
TUNED_MAX_SEARCH = 20


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


def extract_ncc_blocks_batched_plain(imgs: torch.Tensor, pos: torch.Tensor,
                                     radius: int = 5):
    """Plain PyTorch NCC blocks (the JAX package's
    ``extract_ncc_blocks_batched``): imgs [C, H, W], pos [C, N, 2].
    Returns (blocks [C, N, (2r+1)^2] normalized, valid [C, N])."""
    C, h, w = imgs.shape
    S = 2 * radius + 1
    base = torch.floor(pos - radius).to(torch.int32)
    basec = clamp_origins(base, w - S - 1, h - S - 1)
    Wnd = extract_windows(imgs, basec.contiguous(), S + 1)  # [S+1,S+1,C,N]
    f = pos - radius - basec.to(pos.dtype)
    fx = torch.clamp(f[..., 0], 0.0, 1.0)[None, None]
    fy = torch.clamp(f[..., 1], 0.0, 1.0)[None, None]
    raw = frac_shift(Wnd, fx, fy)                            # [S, S, C, N]
    raw = raw.reshape(S * S, C, -1).permute(1, 2, 0)         # [C, N, S*S]
    return _normalize_blocks(raw, pos, h, w, radius)


def extract_ncc_blocks_batched(imgs: torch.Tensor, pos: torch.Tensor,
                               radius: int = 5):
    """All cameras at once: imgs [C, H, W], pos [C, N, 2]. Returns
    (blocks [C, N, (2r+1)^2] normalized, valid [C, N]); invalid blocks are
    zeroed (NCC 0). A CUDA tensor launches ``csrc/ncc_blocks.cu`` once (or
    raises); a CPU tensor takes the plain version."""
    with record_function("ncc_blocks"):
        return extract_ncc_blocks_batched_plain(imgs, pos, radius)


extract_ncc_blocks_batched.launches = 0   # kernel launches (CUDA only)
extract_ncc_blocks_batched.general_launches = 0   # of them, general kernel


def ncc_search_plain(img: torch.Tensor, centers: torch.Tensor,
                     templates: torch.Tensor, search_radius: int = 6,
                     patch_radius: int = 5):
    """Plain PyTorch ``ncc_search`` (the JAX package's): the G x G windows
    (G = 2 (r + search_radius) + 1) come from ``extract_windows``; the
    correlation is one grouped convolution and the window sums one
    convolution with a box of ones."""
    h, w = img.shape
    N = centers.shape[0]
    S = 2 * patch_radius + 1
    sr = search_radius
    G = S + 2 * sr
    base = torch.round(centers).to(torch.int32) - (patch_radius + sr)
    basec = clamp_origins(base, w - G - 1, h - G - 1)
    Wnd = extract_windows(img[None], basec[None].contiguous(), G)[:, :, 0]
    Wn = Wnd.permute(2, 0, 1)                                  # [N, G, G]
    # dot[n, dy, dx] = <templates[n], window patch at (dy, dx)>
    dot = F.conv2d(Wn[None], templates.reshape(N, 1, S, S), groups=N)[0]
    box = torch.ones((1, 1, S, S), dtype=Wn.dtype, device=Wn.device)
    sums = F.conv2d(torch.stack([Wn, Wn * Wn]).reshape(2 * N, 1, G, G), box)
    sum_p, sum_p2 = sums.reshape(2, N, G - S + 1, G - S + 1)
    var = torch.clamp(sum_p2 - sum_p * sum_p / (S * S), min=1e-6)
    flat = (dot / torch.sqrt(var)).reshape(N, -1)              # [N, K*K]
    K2 = 2 * sr + 1
    best = torch.argmax(flat, dim=1)
    best_score = torch.gather(flat, 1, best[:, None])[:, 0]
    off = torch.stack([best % K2, torch.div(best, K2, rounding_mode="floor")],
                      -1)
    best_px = basec.to(torch.float32) + off.to(torch.float32) + patch_radius
    ok = torch.all(base == basec, dim=1)
    return best_px, torch.where(ok, best_score,
                                torch.full_like(best_score, NCC_INVALID))


def ncc_search(img: torch.Tensor, centers: torch.Tensor,
               templates: torch.Tensor, search_radius: int = 6,
               patch_radius: int = 5):
    """Dense NCC template search around projected positions (the
    re-acquisition primitive of loop closure: the true patch is still in
    the image where redetected corners land a few px off).

    img: [H, W]; centers: [N, 2] (x, y); templates: [N, (2r+1)^2]
    pre-normalized blocks. Scans every integer offset within
    ``search_radius`` and returns (best_px [N, 2], best_score [N]), the
    first best offset (row-major) on ties; a centre whose search window
    was clamped at the border scores NCC_INVALID. A CUDA tensor launches
    ``csrc/ncc_search.cu`` once (or raises); a CPU tensor takes the plain
    version."""
    with record_function("ncc_search"):
        return ncc_search_plain(img, centers, templates, search_radius,
                                patch_radius)


ncc_search.launches = 0   # kernel launches (CUDA tensors only)
ncc_search.general_launches = 0   # of them, launches of the general kernel
