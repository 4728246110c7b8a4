"""A frozen copy of coslam_torch's plain PyTorch path (commit 9ecae9a).

The benchmark's reference for the tracked step and the keyframe BA. The
modules are the port's own, cut to what ``slam.fused.frame_step``,
``slam.steps.build_ba_table``, ``solvers.ba.bundle_adjust_table`` and
``slam.steps.apply_ba_table_results`` reach (the merge, loop, mesh,
bootstrap and build paths are not copied), with two more changes: the
imports name this package, and every kernel wrapper (``ops/pyramid.py``,
``ops/klt.py``, ``ops/ncc.py``, ``ops/patches.py``) takes its plain
PyTorch twin on any device, its CUDA branch and ``ops/cuda_lib.py``
left out. Nothing here imports ``coslam_torch``; later changes to the
port do not move it. Importing it sets nothing global (the checks turn
TF32 off themselves while the reference runs).
"""
