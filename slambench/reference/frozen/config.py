"""Typed configuration tree.

Replaces the reference's static-global config classes ``Param`` and ``Const``
(reference: src/app/SL_GlobParam.h:13-47, defaults at SL_GlobParam.cpp:13-37,
src/slam/SL_Define.h:11-20) plus the many tunables hard-coded at call sites
(e.g. classification windows SL_CoSLAM.cpp:423-425, BA window :1345).

Everything is a frozen dataclass so configs can be hashed and reproduced.
This is the PyTorch package's own copy of ``coslam_tpu/config.py`` (the
same fields and defaults): importing that module runs the JAX package's
``__init__``, which imports jax.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class KLTConfig:
    """KLT tracker knobs (reference: v3d_gpuklt.h:180-200 KLT_SequenceTrackerConfig,
    overridden by SL_GlobParam.cpp:28-34 and MyApp.cpp:210-211)."""

    n_iterations: int = 12          # GN iterations per pyramid level
    n_levels: int = 4               # pyramid levels used by the tracker
    level_skip: int = 1             # coarse-to-fine level stride
    window_radius: int = 5          # half-width; patch = (2r+1)^2 px
    ssd_threshold: float = 20000.0  # 8-bit-scale SSD invalidation (MyApp.cpp:210)
    convergence_threshold: float = 0.1   # px update norm for early exit
    min_distance: int = 7           # min corner spacing (NMS radius), px
    min_cornerness: float = 3000.0  # 8-bit-scale cornerness floor (MyApp.cpp:211)
    track_with_gain: bool = True    # estimate per-feature illumination gain
    gain_lambda: float = 100.0      # gain smoothness regularizer
    border: int = 8                 # invalidate features within this many px of edge


@dataclass(frozen=True)
class CapacityConfig:
    """Fixed SoA capacities (reference: SL_Define.h:11-19, SL_GlobParam.cpp:20).

    All device arrays are statically shaped from these; validity masks carry
    the dynamic counts.
    """

    max_cameras: int = 13           # SLAM_MAX_NUM
    max_features: int = 1024        # per camera; 32x32 KLT grid (SL_Define.h:17-18)
    max_map_points: int = 8192      # live map-point slots on device
    max_keyframes: int = 64         # keyframe ring capacity
    ba_window: int = 5              # keyframes per BA window (SL_CoSLAM.cpp:1345)
    max_obs_per_ba: int = 16384     # observation slots in one BA problem
    pose_grid_rows: int = 12        # block grid for chooseStaticFeatPts
    pose_grid_cols: int = 16        # (SL_SingleSLAM.h:36-37)


@dataclass(frozen=True)
class SlamParams:
    """Algorithmic thresholds (reference: SL_GlobParam.cpp:13-37 + call sites)."""

    min_feat_track_len: int = 20     # nMinFeatTrkLen: track maturity for new map pts
    max_err: float = 10.0            # Param::maxErr — IRLS Tukey tau (px)
    max_epi_err: float = 6.0         # Const::MAX_EPI_ERR
    pixel_err_var: float = 10.0      # Const::PIXEL_ERR_VAR — registration gate
    max_dist_ratio: float = 6.0      # Param::maxDistRatio — merge distance gate
    n_max_map_pts: int = 800         # per-frame mapping target (SL_GlobParam.cpp:20)
    num_act_frames: int = 250        # active-point window (SL_CoSLAM.h:61)
    classify_frame_window: int = 60  # isStaticPoint window (SL_CoSLAMHelper)
    maha_inlier: float = 2.0         # pose-update inlier gate (Mahalanobis)
    maha_outlier: float = 6.0        # pose-update outlier gate
    min_static_for_ok: int = 40      # interCamPoseUpdate trigger (SL_CoSLAM.cpp:308-349)
    min_static_cover: float = 0.25   # min image coverage of static points
    keyframe_min_interval: int = 3   # frames between keyframes
    keyframe_trans_ratio: float = 0.01   # translation / scene-depth trigger
    keyframe_angle_deg: float = 5.0      # view-angle-change trigger
    intercam_map_interval: int = 3   # genNewMapPointsInterCam cadence
    merge_min_interval: int = 130    # frames between merge attempts (SL_CoSLAM.cpp:1381)
    merge_overlap_min: int = 50      # checkViewOverlap inlier floor
    merge_overlap_ratio: float = 0.5
    merge_ba_window: int = 16        # keyframes in the merge/loop-time
                                     # joint polish BA (covers both
                                     # groups' separation-era keyframes;
                                     # genMergeInfoVer2's local BA role,
                                     # SL_MergeCameraGroup.cpp:557-725)
    ncc_patch_radius: int = 5        # 11x11 NCC blocks (SL_NCCBlock.h:15-17)
    ncc_min_score: float = 0.6       # NCC acceptance for matching / registration
    ba_max_iter: int = 2             # outer robust iterations (requestForBA)
    ba_inner_iter: int = 30          # inner LM iterations
    ba_cadence: int = 1              # run BA every k-th keyframe
    dyn_max_points: int = 60         # dynamic points in joint pose (InterCamPoseEstimator)
    dyn_neighborhood_px: float = 20.0  # decidePointType: new inter-cam
                                       # points within this Chebyshev
                                       # (square half-width, matching the
                                       # reference's hw=20 mask) distance
                                       # of a dynamic feature mint dynamic
                                       # (SL_NewMapPointsInterCam.cpp:25-91)
    reproj_new_point_gate: float = 3.0   # new-point acceptance reproj error (px)
    new_point_min_parallax_deg: float = 1.0  # min ray angle for triangulation
    init_frames: int = 10            # bootstrap tracking span (nInitFrm role)
    bootstrap_depth: float = 10.0    # monocular scale anchor: median scene depth
    # loop closure (no reference analogue: the reference's merge machinery
    # only realigns ACROSS camera groups; these parameters drive the same
    # machinery when one group revisits its own dormant map)
    loop_min_interval: int = 120     # frames between closure attempts
    loop_dormant_age: int = 250      # unseen-for-this-long points anchor a loop
    loop_overlap_min: int = 30       # dormant projections in view to trigger
    loop_min_inliers: int = 16       # PnP inliers to commit a closure


@dataclass(frozen=True)
class SlamConfig:
    """Top-level config: capacities + KLT + SLAM thresholds + image geometry."""

    num_cameras: int = 1
    image_height: int = 480
    image_width: int = 640
    klt: KLTConfig = dataclasses.field(default_factory=KLTConfig)
    cap: CapacityConfig = dataclasses.field(default_factory=CapacityConfig)
    p: SlamParams = dataclasses.field(default_factory=SlamParams)

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)
