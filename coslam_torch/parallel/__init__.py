"""The multi-device layer (the port of ``coslam_tpu/parallel``): a camera
mesh driven by one controller (``mesh``), the camera-sharded fused step
(``coslam_torch.slam.fused``, ``mesh=``), the distributed Schur BA
(``dist_ba``), the step's scaling and transfer census (``scaling``) and
the dry run of both (``dryrun``)."""

from coslam_torch.parallel.mesh import make_cam_mesh, shard_state  # noqa: F401
from coslam_torch.parallel.dist_ba import dist_bundle_adjust  # noqa: F401
