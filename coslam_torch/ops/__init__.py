"""Tracking front-end ops on batched [C, H, W] images: pyramids, KLT,
corner detection and NCC blocks. The two CUDA kernels (pyramid level,
window extraction) sit behind ``ops/pyramid.py`` and ``ops/patches.py``."""

from coslam_torch.ops.pyramid import build_pyramid, Pyramid  # noqa: F401
from coslam_torch.ops.patches import sample_bilinear, extract_patches  # noqa: F401
from coslam_torch.ops.klt import klt_track, KLTResult  # noqa: F401
from coslam_torch.ops.corners import detect_corners, cornerness_map  # noqa: F401
from coslam_torch.ops.ncc import extract_ncc_blocks_batched  # noqa: F401
