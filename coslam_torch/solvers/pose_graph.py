"""Linear pose-graph solver: rotations then translations (optional unknown
per-edge scale), with fixed anchor nodes (the port of
``coslam_tpu/solvers/pose_graph.py``).

The problems are small (<= a few hundred nodes): the normal equations are
assembled densely and solved with one dense solve; the three rotation
columns share it. Node poses are world->camera (R_i, t_i); an edge
(i -> j) carries (R_ji, t_ji) with R_j = R_ji R_i, t_j = R_ji t_i + s t_ji.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from coslam_torch.geometry.se3 import project_to_so3


class PoseGraph(NamedTuple):
    """Padded pose graph. N nodes, E edges. scale_group: [E] int32, -1 =>
    rigid edge (scale 1), g >= 0 => unknown scale shared by group g."""

    edge_i: torch.Tensor       # [E]
    edge_j: torch.Tensor       # [E]
    edge_R: torch.Tensor       # [E, 3, 3] R_ji
    edge_t: torch.Tensor       # [E, 3] t_ji
    edge_valid: torch.Tensor   # [E] bool
    edge_weight: torch.Tensor  # [E]
    scale_group: torch.Tensor  # [E] int32
    fixed: torch.Tensor        # [N] bool
    fixed_R: torch.Tensor      # [N, 3, 3]
    fixed_t: torch.Tensor      # [N, 3]
    node_valid: torch.Tensor   # [N] bool


_FIX_W = 1e4


def _block_system(pg: PoseGraph, N: int, w: torch.Tensor, B_ij):
    """[N, 3, N, 3] system with identity blocks at (i, i) and (j, j), B_ij
    at (i, j) and its transpose at (j, i) for every edge (weighted by w),
    plus the fixed-node prior and the invalid-node regularizer."""
    dt, dev = pg.edge_R.dtype, pg.edge_R.device
    I3 = torch.eye(3, dtype=dt, device=dev)
    wb = w[:, None, None]
    ei, ej = pg.edge_i.long(), pg.edge_j.long()
    H = torch.zeros((N, N, 3, 3), dtype=dt, device=dev)
    H.index_put_((ei, ei), wb * I3, accumulate=True)
    H.index_put_((ej, ej), wb * I3, accumulate=True)
    H.index_put_((ei, ej), wb * B_ij, accumulate=True)
    H.index_put_((ej, ei), wb * B_ij.transpose(-1, -2), accumulate=True)
    diag_w = pg.fixed.to(dt) * _FIX_W + (~pg.node_valid).to(dt) + 1e-6
    ar = torch.arange(N, device=dev)
    H.index_put_((ar, ar), diag_w[:, None, None] * I3, accumulate=True)
    return H.permute(0, 2, 1, 3).reshape(3 * N, 3 * N)


def solve_rotations(pg: PoseGraph) -> torch.Tensor:
    """Returns [N, 3, 3] rotations (fixed nodes ~= their fixed values)."""
    N = pg.fixed.shape[0]
    dt = pg.edge_R.dtype
    w = pg.edge_valid.to(dt) * pg.edge_weight
    # edge residual x_j - R_ji x_i on each rotation column
    H = _block_system(pg, N, w, -pg.edge_R.transpose(-1, -2))
    rhs = (pg.fixed.to(dt) * _FIX_W)[:, None, None] * pg.fixed_R
    sol = torch.linalg.solve(H, rhs.reshape(3 * N, 3))
    return project_to_so3(sol.reshape(N, 3, 3))


def solve_translations(pg: PoseGraph, R: torch.Tensor, num_scales: int = 1):
    """Solve translations given solved rotations. Edge residual
    t_j - R_ji t_i - s_e t_ji, s_e unknown for scale_group >= 0. Returns
    (t [N, 3], scales [num_scales])."""
    N = pg.fixed.shape[0]
    G = num_scales
    dt, dev = pg.edge_t.dtype, pg.edge_t.device
    w = pg.edge_valid.to(dt) * pg.edge_weight
    has_scale = pg.scale_group >= 0
    g_idx = torch.clamp(pg.scale_group, 0, G - 1).long()
    ei, ej = pg.edge_i.long(), pg.edge_j.long()
    zero = torch.zeros((), dtype=dt, device=dev)
    Jti = -pg.edge_R                                     # [E,3,3]
    Js = torch.where(has_scale[:, None], -pg.edge_t, zero)   # [E,3]
    c = torch.where(has_scale[:, None], zero, -pg.edge_t)    # [E,3]
    H = torch.zeros((3 * N + G, 3 * N + G), dtype=dt, device=dev)
    H[:3 * N, :3 * N] = _block_system(pg, N, w, Jti.transpose(-1, -2))
    # scale-scale and scale-translation coupling; the weak prior pulls
    # unobservable scales toward 1
    s_prior = 1e-4
    Hss = torch.zeros((G,), dtype=dt, device=dev).index_add_(
        0, g_idx, w * torch.sum(Js * Js, -1))
    H[3 * N:, 3 * N:] += torch.diag(Hss + s_prior)
    Hts_i = w[:, None] * torch.einsum("eji,ej->ei", Jti, Js)
    Hts_j = w[:, None] * Js
    Hts = torch.zeros((N, G, 3), dtype=dt, device=dev)
    Hts.index_put_((ei, g_idx), Hts_i, accumulate=True)
    Hts.index_put_((ej, g_idx), Hts_j, accumulate=True)
    Hts = Hts.permute(0, 2, 1).reshape(3 * N, G)
    H[:3 * N, 3 * N:] += Hts
    H[3 * N:, :3 * N] += Hts.T
    bt = torch.zeros((N, 3), dtype=dt, device=dev)
    bt.index_add_(0, ei, -w[:, None] * torch.einsum("eji,ej->ei", Jti, c))
    bt.index_add_(0, ej, -w[:, None] * c)
    bt = bt + (pg.fixed.to(dt) * _FIX_W)[:, None] * pg.fixed_t
    bs = torch.zeros((G,), dtype=dt, device=dev).index_add_(
        0, g_idx, -w * torch.sum(Js * c, -1))
    b = torch.cat([bt.reshape(-1), bs + s_prior])
    sol = torch.linalg.solve(H, b)
    return sol[:3 * N].reshape(N, 3), sol[3 * N:]


def chain_graph(R_rel, t_rel, fixed, fixed_R, fixed_t,
                node_valid) -> PoseGraph:
    """The per-camera chain graph for non-keyframe propagation: N nodes,
    N-1 consecutive edges with the pre-BA relative transforms, key nodes
    fixed to their BA-corrected poses. R_rel[k]/t_rel[k]: node k -> k+1."""
    N = fixed.shape[0]
    E = N - 1
    ar = torch.arange(E, device=t_rel.device)
    return PoseGraph(
        edge_i=ar, edge_j=ar + 1, edge_R=R_rel, edge_t=t_rel,
        edge_valid=node_valid[:-1] & node_valid[1:],
        edge_weight=torch.ones((E,), dtype=t_rel.dtype, device=t_rel.device),
        scale_group=torch.full((E,), -1, dtype=torch.int32,
                               device=t_rel.device),
        fixed=fixed, fixed_R=fixed_R, fixed_t=fixed_t,
        node_valid=node_valid)


def solve_chain_segments(R_rel, t_rel, fixed, fixed_R, fixed_t,
                         chain_scales: bool = False, device=None):
    """Per-segment chain correction for long trajectories: consecutive
    anchors decouple the chain, so each segment (padded to a power-of-two
    size) is solved on its own; the stretch after the last anchor is rigid
    propagation. Inputs and outputs are numpy ([F-1,3,3], [F-1,3] edges
    k->k+1; [F] anchor mask; [F,3,3]/[F,3] poses with anchor values at
    anchor rows). Returns (R [F,3,3], t [F,3])."""
    F = fixed.shape[0]
    R_out = np.array(fixed_R, np.float32, copy=True)
    t_out = np.array(fixed_t, np.float32, copy=True)
    anchors = np.nonzero(fixed)[0]
    if len(anchors) == 0 or F < 2:
        return R_out, t_out

    def T(a):
        return torch.as_tensor(a, device=device)

    for k in range(len(anchors) - 1):
        i0, i1 = int(anchors[k]), int(anchors[k + 1])
        n = i1 - i0 + 1
        if n <= 2:
            continue                      # no interior nodes to correct
        m = max(8, 1 << (n - 1).bit_length())
        fx = np.zeros(m, bool)
        fx[0] = fx[n - 1] = True
        fR = np.tile(np.eye(3, dtype=np.float32), (m, 1, 1))
        fT = np.zeros((m, 3), np.float32)
        fR[0], fT[0] = fixed_R[i0], fixed_t[i0]
        fR[n - 1], fT[n - 1] = fixed_R[i1], fixed_t[i1]
        Rr = np.tile(np.eye(3, dtype=np.float32), (m - 1, 1, 1))
        tr = np.zeros((m - 1, 3), np.float32)
        Rr[: n - 1] = R_rel[i0:i1]
        tr[: n - 1] = t_rel[i0:i1]
        nv = np.arange(m) < n
        pg = chain_graph(T(Rr), T(tr), T(fx), T(fR), T(fT), T(nv))
        if chain_scales:
            sg = np.where(np.arange(m - 1) < n - 1, 0, -1).astype(np.int32)
            pg = pg._replace(scale_group=T(sg))
        R_sol = solve_rotations(pg)
        t_sol, _ = solve_translations(pg, R_sol, num_scales=1)
        R_out[i0:i1 + 1] = R_sol.cpu().numpy()[:n]
        t_out[i0:i1 + 1] = t_sol.cpu().numpy()[:n]
        R_out[i0], t_out[i0] = fixed_R[i0], fixed_t[i0]
        R_out[i1], t_out[i1] = fixed_R[i1], fixed_t[i1]
    # trailing stretch: rigid composition from the last anchor
    a = int(anchors[-1])
    R_out[a], t_out[a] = fixed_R[a], fixed_t[a]
    for f in range(a + 1, F):
        R_out[f] = R_rel[f - 1] @ R_out[f - 1]
        t_out[f] = t_rel[f - 1] + R_rel[f - 1] @ t_out[f - 1]
    return R_out, t_out
