"""Robust M-estimator weight functions (Tukey biweight, Huber)."""

from __future__ import annotations

import torch


def tukey_weight(r: torch.Tensor, tau: float) -> torch.Tensor:
    """IRLS weight for residual magnitude r: (1 - (r/tau)^2)^2, 0 beyond tau."""
    u = r / tau
    w = torch.square(1.0 - torch.square(u))
    return torch.where(torch.abs(u) < 1.0, w, torch.zeros_like(w))


def huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight: 1 inside delta, delta/|r| outside."""
    a = torch.abs(r)
    return torch.where(a <= delta, torch.ones_like(a),
                       delta / torch.clamp(a, min=1e-12))
