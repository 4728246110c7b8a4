"""Tracking front-end ops on batched [C, H, W] images: pyramids, KLT,
corner detection and NCC blocks. The CUDA kernels (``csrc/*.cu``, built by
``ops/cuda_lib.py``) sit behind ``ops/pyramid.py`` (the pyramid),
``ops/klt.py`` (KLT), ``ops/ncc.py`` (NCC blocks, template search) and
``ops/patches.py`` (window extraction)."""

from coslam_torch.ops.pyramid import build_pyramid, Pyramid  # noqa: F401
from coslam_torch.ops.patches import sample_bilinear, extract_patches  # noqa: F401
from coslam_torch.ops.klt import klt_track, KLTResult  # noqa: F401
from coslam_torch.ops.corners import detect_corners, cornerness_map  # noqa: F401
from coslam_torch.ops.ncc import extract_ncc_blocks_batched  # noqa: F401
