"""Micro-profile of the windowed BA's internals (the port of
``examples/profile_ba.py``).

Times, at the bench shape (15 cameras x 2048 points x 6144
observations):
  - ``_ba_normal_terms`` (Jacobians and segment-sum accumulation);
  - ``_schur_solve`` (point elimination and the dense reduced solve);
  - ``bundle_adjust`` with 2 x 30 LM iterations, as LM iterations/s.
Each timed window opens after a ``torch.cuda.synchronize()`` and closes
on one before the clock stops; the calls are chained through their
outputs. Everything runs on the card's default stream (the engine's
async BA is not used).

    python -m coslam_torch.examples.profile_ba [--iters 30] [--cpu]

Runs on the CUDA card unless given ``--cpu``; raises without a card
otherwise. The first line names the card and its power limit (nvidia-smi)
or ``cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from coslam_torch.examples.profile_stages import sync
from coslam_torch.util import resolve_device


def bench_problem(M: int = 15, n_points: int = 2048, device=None):
    """The bench's BA problem from seed 0, drawn in the reference's order:
    points in a box 10 units ahead, cameras 0.2 apart along x with small
    random rotations, three observations a point of a random camera, the
    first two cameras fixed, the points started 0.05 off. Observation
    indices are int64 (the port's index type)."""
    from coslam_torch.geometry.se3 import so3_exp_np
    from coslam_torch.solvers.ba import BAProblem
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    W, H = 640, 480
    K1 = np.array([[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1]],
                  np.float32)
    Xw = rng.uniform(-4, 4, (n_points, 3)).astype(np.float32)
    Xw[:, 2] += 10
    Rb = np.stack([so3_exp_np(0.05 * rng.standard_normal(3).astype(
        np.float32)) for _ in range(M)])
    tb = np.stack([np.array([0.2 * m, 0, 0], np.float32) for m in range(M)])
    oc = rng.integers(0, M, 3 * n_points).astype(np.int32)
    op = np.tile(np.arange(n_points), 3).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", Rb[oc], Xw[op]) + tb[oc]
    px = (Xc[:, :2] / Xc[:, 2:3] * 500 + [W / 2, H / 2]).astype(np.float32)
    cam_fixed = np.zeros(M, bool)
    cam_fixed[:2] = True

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    return BAProblem(
        K=t(np.broadcast_to(K1[None], (M, 3, 3)).copy()), R=t(Rb), t=t(tb),
        X=t(Xw + 0.05), obs_cam=t(oc, torch.int64),
        obs_pt=t(op, torch.int64), obs_px=t(px),
        obs_valid=torch.ones(len(oc), dtype=torch.bool, device=dev),
        cam_fixed=t(cam_fixed), point_fixed=torch.zeros(
            n_points, dtype=torch.bool, device=dev))


def normal_terms(prob, X):
    """(Hcc, Wcp, Hpp, gc, gp, cost) at the problem's poses and ``X``,
    every observation weighted 1."""
    from coslam_torch.solvers.ba import _ba_normal_terms
    w = prob.obs_valid.to(torch.float32)
    return _ba_normal_terms(prob.K, prob.R, prob.t, X, prob, w)


def schur_step(prob, terms, gc):
    """One damped Schur step (lambda 1e-4) on ``terms`` with the camera
    gradient ``gc``: (dc, dX)."""
    from coslam_torch.solvers.ba import _schur_solve
    Hcc, Wcp, Hpp, _, gp, _ = terms
    lam = torch.full((), 1e-4, dtype=torch.float32, device=gc.device)
    return _schur_solve(Hcc, Wcp, Hpp, gc, gp, lam, prob.cam_fixed,
                        prob.point_fixed)


def solve(prob, inner_iter: int = 30):
    """``bundle_adjust`` as the bench calls it: max_err 10, 2 outer
    passes of ``inner_iter`` LM iterations."""
    from coslam_torch.solvers.ba import bundle_adjust
    return bundle_adjust(prob, max_err=10.0, max_iter=2,
                         inner_iter=inner_iter)


def run(iters: int = 30, M: int = 15, n_points: int = 2048,
        inner_iter: int = 30, reps: int = 5, device=None) -> dict:
    """Time the three; print the reference's lines. Returns
    {"normal_terms_ms", "schur_solve_ms", "bundle_adjust_ms",
    "lm_iters_per_s", "cost"}."""
    dev = resolve_device(device)
    prob = bench_problem(M, n_points, dev)
    n = iters

    out = normal_terms(prob, prob.X)
    sync(dev)
    t0 = time.perf_counter()
    X = prob.X
    for _ in range(n):
        out = normal_terms(prob, X)
        X = X + 0.0 * out[4]          # chain through gp
    sync(dev)
    dt_terms = (time.perf_counter() - t0) / n * 1e3
    print(f"normal_terms          {dt_terms:8.3f} ms", flush=True)

    gc = out[3]
    dc, dX = schur_step(prob, out, gc)
    sync(dev)
    t0 = time.perf_counter()
    g = gc
    for _ in range(n):
        dc, dX = schur_step(prob, out, g)
        g = g + 0.0 * dc              # chain
    sync(dev)
    dt_solve = (time.perf_counter() - t0) / n * 1e3
    print(f"schur_solve           {dt_solve:8.3f} ms", flush=True)

    # the full solver: LM iterations/s over max_iter x inner_iter
    res = solve(prob, inner_iter)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        res = solve(prob._replace(X=res.X), inner_iter)
    sync(dev)
    dt_full = time.perf_counter() - t0
    lm = reps * 2 * inner_iter / dt_full
    print(f"bundle_adjust (2x{inner_iter})  {dt_full / reps * 1e3:8.3f} ms  "
          f"= {lm:7.1f} LM iters/s")
    return {"normal_terms_ms": dt_terms, "schur_solve_ms": dt_solve,
            "bundle_adjust_ms": dt_full / reps * 1e3, "lm_iters_per_s": lm,
            "cost": float(res.cost)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from coslam_torch.examples.accuracy_bench import device_label
    device = "cpu" if args.cpu else None
    print(device_label(device), flush=True)        # raises without a card
    return run(iters=args.iters, device=device)


if __name__ == "__main__":
    main()
