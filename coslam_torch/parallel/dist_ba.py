"""Distributed windowed BA (the port of ``coslam_tpu/parallel/dist_ba.py``).

Each function splits a problem over a ``CamMesh`` and calls the solver of
``coslam_torch.solvers.ba`` with the mesh, which runs one LM loop over the
shards: each device accumulates or eliminates its part, the reduced camera
system's parts are summed on the mesh's first device (the JAX package's
``psum`` over ICI), the dense solve runs there once, and the step goes back
to the shards. The per-observation (or per-point) results come back to the
first device and are concatenated there.
"""

from __future__ import annotations

import torch

from coslam_torch.solvers.ba import (BAProblem, BAResult, BATableProblem,
                                     BATableResult, bundle_adjust,
                                     bundle_adjust_table)


def _replicas(mesh, x, leaf: str):
    return mesh.scatter([x] * len(mesh), leaf)


def dist_bundle_adjust(prob: BAProblem, mesh, max_err: float = 10.0,
                       max_iter: int = 2, inner_iter: int = 10) -> BAResult:
    """The observation-list BA with the observations split over the mesh.
    The observation count must be divisible by the mesh size (pad with
    obs_valid=False). Cameras and points go to every device whole."""
    if prob.obs_cam.shape[0] % len(mesh):
        raise ValueError(f"{prob.obs_cam.shape[0]} observations do not "
                         f"divide over a mesh of {len(mesh)} devices")
    parts = {}
    for name, x in zip(BAProblem._fields, prob):
        leaf = f"ba_problem.{name}"
        parts[name] = mesh.scatter(x, leaf) if name.startswith("obs_") \
            else _replicas(mesh, x, leaf)
    shards = [BAProblem(**{k: v[i] for k, v in parts.items()})
              for i in range(len(mesh))]
    res = bundle_adjust(shards, max_err=max_err, max_iter=max_iter,
                        inner_iter=inner_iter, mesh=mesh)
    return res[0]._replace(
        obs_outlier=torch.cat(mesh.gather([r.obs_outlier for r in res],
                                          "ba_result.obs_outlier")),
        obs_err=torch.cat(mesh.gather([r.obs_err for r in res],
                                      "ba_result.obs_err")))


# the table problem's point-axis leaves and the axis each splits along
_TABLE_SPLIT = {"X": 0, "obs_px": 2, "obs_valid": 1, "point_fixed": 0}


def dist_bundle_adjust_table(prob: BATableProblem, mesh,
                             max_err: float = 10.0, max_iter: int = 2,
                             inner_iter: int = 10) -> BATableResult:
    """The dense-table BA with the POINT axis split over the mesh: each
    device eliminates its points, the reduced [6S, 6S] camera system is
    summed and solved on the first device, back-substitution stays on the
    shards. The point count must be divisible by the mesh size (pad with
    obs_valid=False and point_fixed=True)."""
    if prob.X.shape[0] % len(mesh):
        raise ValueError(f"{prob.X.shape[0]} points do not divide over a "
                         f"mesh of {len(mesh)} devices")
    parts = {}
    for name, x in zip(BATableProblem._fields, prob):
        leaf = f"ba_problem.{name}"
        parts[name] = mesh.scatter(x, leaf, dim=_TABLE_SPLIT[name]) \
            if name in _TABLE_SPLIT else _replicas(mesh, x, leaf)
    shards = [BATableProblem(**{k: v[i] for k, v in parts.items()})
              for i in range(len(mesh))]
    res = bundle_adjust_table(shards, max_err=max_err, max_iter=max_iter,
                              inner_iter=inner_iter, mesh=mesh)

    def cat(field: str, dim: int):
        return torch.cat(mesh.gather([getattr(r, field) for r in res],
                                     f"ba_result.{field}"), dim=dim)
    return res[0]._replace(X=cat("X", 0), obs_outlier=cat("obs_outlier", 1),
                           obs_err=cat("obs_err", 1),
                           obs_valid=cat("obs_valid", 1))
