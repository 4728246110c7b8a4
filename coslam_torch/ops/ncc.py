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

from coslam_torch.ops import cuda_lib
from coslam_torch.ops.patches import clamp_origins, extract_windows, frac_shift
from coslam_torch.spans import span

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


def _check_radius(name: str, what: str, radius: int) -> None:
    if radius < 0:
        raise ValueError(f"{name}: {what} {radius} is negative")


def _ncc_blocks_cuda(imgs: torch.Tensor, pos: torch.Tensor, radius: int):
    name = "extract_ncc_blocks_batched"
    if imgs.dtype != torch.float32 or imgs.dim() != 3 or \
            not imgs.is_contiguous():
        raise ValueError(f"{name} takes imgs [C, H, W] contiguous float32, "
                         f"got {imgs.dtype} {tuple(imgs.shape)}")
    C, H, W = imgs.shape
    if pos.dtype != torch.float32 or pos.dim() != 3 or \
            pos.shape[0] != C or pos.shape[2] != 2:
        raise ValueError(f"{name} takes pos [{C}, N, 2] float32, got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    if pos.device != imgs.device:
        raise ValueError(f"{name}: imgs and pos on different devices")
    _check_radius(name, "radius", radius)
    S = 2 * radius + 1
    if S + 1 > min(H, W):
        raise ValueError(f"{name}: a {H}x{W} image is smaller than the "
                         f"{S + 1}-px window")
    pos = pos.contiguous()
    N = pos.shape[1]
    blocks = torch.empty((C, N, S * S), dtype=imgs.dtype, device=imgs.device)
    ok = torch.empty((C, N), dtype=torch.bool, device=imgs.device)
    if C * N == 0:
        return blocks, ok
    fn = cuda_lib.library("ncc_blocks").ncc_blocks
    with torch.cuda.device(imgs.device):
        # the in-bounds limits as the plain version compares them: Python
        # floats, rounded to float32
        rc = fn(imgs.data_ptr(), pos.data_ptr(), blocks.data_ptr(),
                ok.data_ptr(), C, H, W, N, radius, W - 1.001 - radius,
                H - 1.001 - radius, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check("ncc_blocks", rc)
    extract_ncc_blocks_batched.launches += 1
    extract_ncc_blocks_batched.general_launches += radius > TUNED_MAX_RADIUS
    return blocks, ok


def extract_ncc_blocks_batched(imgs: torch.Tensor, pos: torch.Tensor,
                               radius: int = 5):
    """All cameras at once: imgs [C, H, W], pos [C, N, 2]. Returns
    (blocks [C, N, (2r+1)^2] normalized, valid [C, N]); invalid blocks are
    zeroed (NCC 0). A CUDA tensor launches ``csrc/ncc_blocks.cu`` once (or
    raises); a CPU tensor takes the plain version."""
    with span("ncc_blocks"):
        if imgs.is_cuda or pos.is_cuda:
            return _ncc_blocks_cuda(imgs, pos, radius)
        return extract_ncc_blocks_batched_plain(imgs, pos, radius)


extract_ncc_blocks_batched.launches = 0   # kernel launches (CUDA only)
extract_ncc_blocks_batched.general_launches = 0   # of them, general kernel


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


def ncc_pairwise(blocks_a: torch.Tensor, blocks_b: torch.Tensor):
    """Row-wise NCC of aligned block sets [N, S] -> [N] (matchNCCBlock for
    a known point)."""
    return torch.sum(blocks_a * blocks_b, dim=-1)


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


def _ncc_search_cuda(img: torch.Tensor, centers: torch.Tensor,
                     templates: torch.Tensor, search_radius: int,
                     patch_radius: int):
    if img.dtype != torch.float32 or img.dim() != 2 or \
            not img.is_contiguous():
        raise ValueError(f"ncc_search takes img [H, W] contiguous float32, "
                         f"got {img.dtype} {tuple(img.shape)}")
    H, W = img.shape
    if centers.dtype != torch.float32 or centers.dim() != 2 or \
            centers.shape[1] != 2:
        raise ValueError(f"ncc_search takes centers [N, 2] float32, got "
                         f"{centers.dtype} {tuple(centers.shape)}")
    _check_radius("ncc_search", "patch_radius", patch_radius)
    _check_radius("ncc_search", "search_radius", search_radius)
    N = centers.shape[0]
    S = 2 * patch_radius + 1
    if templates.dtype != torch.float32 or \
            tuple(templates.shape) != (N, S * S) or \
            not templates.is_contiguous():
        raise ValueError(f"ncc_search takes templates [{N}, {S * S}] "
                         f"contiguous float32, got {templates.dtype} "
                         f"{tuple(templates.shape)}")
    if centers.device != img.device or templates.device != img.device:
        raise ValueError("ncc_search: img, centers and templates on "
                         "different devices")
    G = S + 2 * search_radius
    if G + 1 > min(H, W):
        raise ValueError(f"ncc_search: a {H}x{W} image is smaller than the "
                         f"{G + 1}-px search window")
    centers = centers.contiguous()
    best_px = torch.empty((N, 2), dtype=img.dtype, device=img.device)
    best_score = torch.empty((N,), dtype=img.dtype, device=img.device)
    if N == 0:
        return best_px, best_score
    fn = cuda_lib.library("ncc_search").ncc_search
    with torch.cuda.device(img.device):
        rc = fn(img.data_ptr(), centers.data_ptr(), templates.data_ptr(),
                best_px.data_ptr(), best_score.data_ptr(), H, W, N,
                patch_radius, search_radius,
                torch.cuda.current_stream().cuda_stream)
    cuda_lib.check("ncc_search", rc)
    ncc_search.launches += 1
    ncc_search.general_launches += patch_radius > TUNED_MAX_RADIUS or \
        search_radius > TUNED_MAX_SEARCH
    return best_px, best_score


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
    with span("ncc_search"):
        if img.is_cuda or centers.is_cuda or templates.is_cuda:
            return _ncc_search_cuda(img, centers, templates, search_radius,
                                    patch_radius)
        return ncc_search_plain(img, centers, templates, search_radius,
                                patch_radius)


ncc_search.launches = 0   # kernel launches (CUDA tensors only)
ncc_search.general_launches = 0   # of them, launches of the general kernel
