"""Guided feature matching: epipolar + NCC score matrices and greedy
mutual-best assignment (the port of ``coslam_tpu/ops/matching.py``).

The score matrix is one [A, B] product of pre-normalized NCC blocks,
masked by epipolar distance and/or a disparity bound; the assignment is a
fixed number of mutual-best rounds, each of which retires the matched
rows and columns, so no round syncs with the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coslam_torch.ops.ncc import NCC_INVALID, ncc_score_matrix


def epipolar_distance_matrix(F: torch.Tensor, pts_a: torch.Tensor,
                             pts_b: torch.Tensor) -> torch.Tensor:
    """Symmetric epipolar distance of every (a, b) pair: [A, B] px. F maps
    image-a points to epilines in image b (x_b^T F x_a = 0)."""
    ah = torch.cat([pts_a, torch.ones_like(pts_a[:, :1])], dim=-1)
    bh = torch.cat([pts_b, torch.ones_like(pts_b[:, :1])], dim=-1)
    lb = ah @ F.T                      # [A, 3] lines in image b
    la = bh @ F                        # [B, 3] lines in image a
    num_b = torch.abs(lb @ bh.T)       # [A, B]
    den_b = torch.clamp(torch.linalg.norm(lb[:, :2], dim=-1, keepdim=True),
                        min=1e-9)
    num_a = torch.abs(la @ ah.T).T     # [A, B]
    den_a = torch.clamp(torch.linalg.norm(la[:, :2], dim=-1, keepdim=True),
                        min=1e-9).T
    return 0.5 * (num_b / den_b + num_a / den_a)


class MatchResult(NamedTuple):
    a_to_b: torch.Tensor   # [A] index into b, -1 = unmatched
    score: torch.Tensor    # [A] NCC score of the match


def greedy_mutual_match(score: torch.Tensor, min_score: float = 0.6,
                        rounds: int = 8) -> MatchResult:
    """Greedy conflict-free assignment from a score matrix (higher =
    better; invalid entries <= NCC_INVALID): ``rounds`` mutual-best sweeps.
    ``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does."""
    A, B = score.shape
    dev = score.device
    s = score
    ar = torch.arange(A, device=dev)
    a_to_b = torch.full((A,), -1, dtype=torch.int64, device=dev)
    best_s = torch.full((A,), NCC_INVALID, dtype=score.dtype, device=dev)
    invalid = torch.full((), NCC_INVALID, dtype=score.dtype, device=dev)
    for _ in range(rounds):
        bb = torch.argmax(s, dim=1)                      # [A] best b per a
        sv = torch.gather(s, 1, bb[:, None])[:, 0]
        ba = torch.argmax(s, dim=0)                      # [B] best a per b
        mutual = (ba[bb] == ar) & (sv > min_score)
        a_to_b = torch.where(mutual & (a_to_b < 0), bb, a_to_b)
        best_s = torch.where(mutual & (best_s <= NCC_INVALID), sv, best_s)
        # retire matched rows and columns: a max-scatter into a sentinel
        # column B (unmatched rows land there and are cut off)
        row_dead = a_to_b >= 0
        col_dead = torch.zeros((B + 1,), dtype=torch.uint8, device=dev)
        col_dead = col_dead.scatter_reduce(
            0, torch.where(row_dead, a_to_b, B), row_dead.to(torch.uint8),
            reduce="amax")[:B].bool()
        s = torch.where(row_dead[:, None] | col_dead[None, :], invalid, s)
    return MatchResult(a_to_b=a_to_b.to(torch.int32), score=best_s)


def guided_match(blocks_a, blocks_b, valid_a, valid_b, pts_a, pts_b,
                 F: torch.Tensor | None = None, max_epi: float = 6.0,
                 min_ncc: float = 0.6, max_disparity: float | None = None,
                 rounds: int = 8) -> MatchResult:
    """Epipolar + NCC guided matching (getEpiNccMat + greedyGuidedNCCMatch).
    blocks_*: [N, S] pre-normalized NCC blocks; pts_*: [N, 2] pixels. With
    F given, pairs beyond ``max_epi`` px of epipolar distance are
    excluded; ``max_disparity`` bounds |pa - pb|."""
    s = ncc_score_matrix(blocks_a, blocks_b, valid_a, valid_b)
    invalid = torch.full_like(s, NCC_INVALID)
    if F is not None:
        d = epipolar_distance_matrix(F, pts_a, pts_b)
        s = torch.where(d <= max_epi, s, invalid)
    if max_disparity is not None:
        disp = torch.linalg.norm(pts_a[:, None, :] - pts_b[None, :, :], dim=-1)
        s = torch.where(disp <= max_disparity, s, invalid)
    return greedy_mutual_match(s, min_score=min_ncc, rounds=rounds)
