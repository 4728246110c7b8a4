"""solvers (PyTorch port; see the same-named package of coslam_tpu)."""

from coslam_torch.solvers.pose import (IRLSPoseResult, irls_pose,  # noqa: F401
                                       irls_pose_epi)
