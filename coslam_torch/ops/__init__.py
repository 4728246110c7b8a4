"""Tracking front-end ops on batched [C, H, W] images: pyramids, KLT,
corner detection, NCC blocks, and TV-L1 flow (``ops/flow.py``, plain
PyTorch: the pipeline does not call it). The CUDA kernels (``csrc/*.cu``,
built by ``ops/cuda_lib.py``) sit behind ``ops/pyramid.py`` (the pyramid),
``ops/klt.py`` (KLT), ``ops/ncc.py`` (NCC blocks, template search) and
``ops/patches.py`` (window extraction)."""

from coslam_torch.ops.pyramid import build_pyramid, Pyramid  # noqa: F401
from coslam_torch.ops.patches import sample_bilinear, extract_patches  # noqa: F401
from coslam_torch.ops.klt import klt_track, KLTResult  # noqa: F401
from coslam_torch.ops.corners import detect_corners, cornerness_map  # noqa: F401
from coslam_torch.ops.ncc import extract_ncc_blocks_batched  # noqa: F401
from coslam_torch.ops.flow import tvl1_flow  # noqa: F401


def kernel_wrappers() -> dict:
    """The CUDA kernels' wrappers by kernel name. Each counts in its
    ``launches`` attribute the launches of its kernel (CUDA tensors only);
    callers set the counts to 0 before a run and read them after it
    (``reset_launch_counts``, ``launch_counts``)."""
    from coslam_torch.ops.ncc import ncc_search
    from coslam_torch.ops.patches import extract_windows
    return {"build_pyramid": build_pyramid, "klt_track": klt_track,
            "extract_windows": extract_windows,
            "ncc_blocks": extract_ncc_blocks_batched,
            "ncc_search": ncc_search}


# the kernels with a general path for radii above their tuned ones; each
# wrapper also counts those launches in ``general_launches``
GENERAL_PATHS = ("klt_track", "ncc_blocks", "ncc_search")


def launch_counts() -> dict:
    """Every kernel's launches by name, and the general-path launches of
    the kernels in GENERAL_PATHS under ``<name>_general``."""
    wrappers = kernel_wrappers()
    return {**{k: fn.launches for k, fn in wrappers.items()},
            **{f"{k}_general": wrappers[k].general_launches
               for k in GENERAL_PATHS}}


def reset_launch_counts() -> None:
    """Set every count of launch_counts to 0."""
    for k, fn in kernel_wrappers().items():
        fn.launches = 0
        if k in GENERAL_PATHS:
            fn.general_launches = 0
