"""coslam_torch — collaborative visual SLAM in PyTorch and CUDA.

The PyTorch port of ``coslam_tpu`` (same algorithms, same state layout,
same module names) for one NVIDIA H100. Plain tensor code is PyTorch;
each Pallas TPU kernel of the JAX package is a CUDA kernel written for
Hopper (``coslam_torch/csrc``), with a plain PyTorch twin beside its
wrapper that CPU tensors take.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; they never fall back to the CPU on their own.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry (SE(3), triangulation, LM/BA solves) needs true f32 matmuls:
# TF32 keeps ~3 decimal digits and breaks rotation orthonormality at the
# 1e-4 level, as bf16 passes did on the TPU (coslam_tpu/__init__.py).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from coslam_torch.config import SlamConfig, small_test_config  # noqa: E402,F401


def __getattr__(name):
    # lazy: CoSlamEngine pulls the whole pipeline stack
    if name == "CoSlamEngine":
        from coslam_torch.slam.pipeline import CoSlamEngine
        return CoSlamEngine
    raise AttributeError(name)
