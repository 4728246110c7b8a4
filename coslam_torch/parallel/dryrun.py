"""Multi-device dry run (the port of ``coslam_tpu/parallel/dryrun.py``):
one camera-sharded fused step (tracking, pose and mapping) and both
distributed BAs on an n-device mesh, with the JAX dry run's data and
asserts. ``devices`` names the mesh's devices (repeats allowed, e.g.
``["cpu"] * 8``); by default the first n visible cards.
"""

from __future__ import annotations

import numpy as np
import torch

from coslam_torch.parallel.dist_ba import (dist_bundle_adjust,
                                           dist_bundle_adjust_table)
from coslam_torch.parallel.mesh import make_cam_mesh
from coslam_torch.parallel.scaling import mesh_cfg, step_inputs
from coslam_torch.slam.fused import frame_step
from coslam_torch.solvers.ba import BAProblem, BATableProblem


def _check(ok, what: str):
    if not ok:
        raise AssertionError(f"dry run: {what}")


def run_dryrun(n_devices: int, h: int = 96, w: int = 128, feats: int = 128,
               verbose: bool = True, devices=None) -> dict:
    """Run the three calls and check them. Returns what each found:
    n_tracked per camera, the list and table BAs' costs and the list BA's
    median reprojection error."""
    mesh = make_cam_mesh(n_devices, devices=devices)
    C = n_devices                     # one camera per device
    cfg = mesh_cfg(C, h, w, feats)
    rng = np.random.default_rng(0)
    state, pyr0, imgs_cur, K, kc = step_inputs(cfg, mesh, rng)

    # 1) the fused step: pixels camera-sharded, state on the first device
    state, pyr, stats = frame_step(state, pyr0, imgs_cur, K, kc, cfg,
                                   mesh=mesh)
    n_tracked = stats.n_tracked.cpu().numpy()
    if verbose:
        print(f"[dryrun] fused step on {n_devices}-device mesh: "
              f"n_tracked={n_tracked.tolist()}", flush=True)
    _check((n_tracked >= 0).all(), f"n_tracked {n_tracked.tolist()}")

    # 2) distributed Schur BA: a synthetic window, observations split by
    # camera
    main = mesh.main
    M = 2 * C                         # 2 keyframes x C cameras
    Ppts = 256
    X = rng.uniform(-3, 3, (Ppts, 3)).astype(np.float32)
    X[:, 2] += 8
    Rb = np.broadcast_to(np.eye(3, dtype=np.float32), (M, 3, 3)).copy()
    tb = np.zeros((M, 3), np.float32)
    tb[:, 0] = 0.1 * np.arange(M)
    obs_per_cam = Ppts
    O = C * obs_per_cam
    obs_cam = np.repeat(np.arange(C), obs_per_cam).astype(np.int32)
    obs_pt = np.tile(np.arange(obs_per_cam), C).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", Rb[obs_cam], X[obs_pt]) + tb[obs_cam]
    obs_px = (Xc[:, :2] / Xc[:, 2:3] * 120.0
              + np.array([w / 2, h / 2])).astype(np.float32)
    obs_px += 0.3 * rng.standard_normal(obs_px.shape).astype(np.float32)
    cam_fixed = np.zeros(M, bool)
    cam_fixed[:2] = True

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(main)
    KM = K[0][None].expand(M, 3, 3).contiguous()
    prob = BAProblem(
        K=KM, R=T(Rb), t=T(tb), X=T(X + 0.05), obs_cam=T(obs_cam),
        obs_pt=T(obs_pt), obs_px=T(obs_px), obs_valid=T(np.ones(O, bool)),
        cam_fixed=T(cam_fixed), point_fixed=T(np.zeros(Ppts, bool)))
    res = dist_bundle_adjust(prob, mesh, max_err=10.0, max_iter=2,
                             inner_iter=8)
    cost = float(res.cost)
    med = float(torch.median(res.obs_err))
    if verbose:
        print(f"[dryrun] distributed Schur BA over {n_devices} devices: "
              f"cost={cost:.3f} median_err={med:.3f}px", flush=True)
    _check(np.isfinite(cost), f"list BA cost {cost}")
    _check(med < 2.0, f"distributed BA did not converge (median {med})")

    # 3) the distributed dense-table BA (the engine's form): points split,
    # the camera system summed on the first device. Where the mesh size
    # does not divide the 256 points (5 devices), they are padded with
    # points of no observation, frozen (the JAX package's dry run needs
    # a mesh size that divides them)
    Pt = Ppts + (-Ppts) % n_devices
    tbl_valid = np.zeros((M, Pt), bool)
    tbl_px = np.zeros((M, 2, Pt), np.float32)
    tbl_valid[obs_cam, obs_pt] = True
    tbl_px[obs_cam, 0, obs_pt] = obs_px[:, 0]
    tbl_px[obs_cam, 1, obs_pt] = obs_px[:, 1]
    pf = tbl_valid.sum(0) < 2
    Xt = np.concatenate([X + 0.05, np.tile(np.float32([0, 0, 8]),
                                           (Pt - Ppts, 1))])
    probT = BATableProblem(
        K=KM, R=T(Rb), t=T(tb), X=T(Xt), obs_px=T(tbl_px),
        obs_valid=T(tbl_valid), cam_fixed=T(cam_fixed), point_fixed=T(pf))
    resT = dist_bundle_adjust_table(probT, mesh, max_err=10.0, max_iter=2,
                                    inner_iter=8)
    costT = float(resT.cost)
    if verbose:
        print(f"[dryrun] distributed table BA over {n_devices} devices: "
              f"cost={costT:.3f}", flush=True)
    _check(np.isfinite(costT), f"table BA cost {costT}")
    if verbose:
        print(f"[dryrun] OK: {n_devices}-device mesh, camera-sharded step "
              f"+ Schur BA summed on the first device (list + table forms)",
              flush=True)
    return dict(n_tracked=n_tracked.tolist(), list_cost=cost,
                list_median_err=med, table_cost=costT)
