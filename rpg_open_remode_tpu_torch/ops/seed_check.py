"""Seed convergence classification (counterpart of
``rpg_open_remode_tpu/ops/seed_check.py``, the reference's
``seedCheckKernel``, src/seed_check.cu:28-67)."""

from __future__ import annotations

import torch

from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig
from rpg_open_remode_tpu_torch.ops import rect_head_cuda


def border_mask(height: int, width: int, cfg: RemodeConfig, device=None) -> torch.Tensor:
    """Static BORDER ring: within ``patch_side`` pixels of any edge (the
    reference margin is the full patch side, seed_check.cu:37-42)."""
    m = cfg.patch_side
    y = torch.arange(height, device=device)[:, None]
    x = torch.arange(width, device=device)[None, :]
    inside = (x >= m) & (x <= width - m - 1) & (y >= m) & (y <= height - m - 1)
    return ~inside


def classify_seeds(mu, sigma_sq, a, b, epsilon, border, cfg: RemodeConfig) -> torch.Tensor:
    """Per-pixel state in {BORDER, CONVERGED, DIVERGED, UPDATE}
    (seed_check.cu:44-66)."""
    e_pi = a / (a + b)
    converged = (e_pi > cfg.eta_inlier) & (sigma_sq < epsilon)
    diverged = (a - 1.0) / (a + b - 2.0) < cfg.eta_outlier
    out = torch.where(
        diverged,
        int(ConvergenceState.DIVERGED),
        int(ConvergenceState.UPDATE),
    )
    out = torch.where(converged, int(ConvergenceState.CONVERGED), out)
    return torch.where(border, int(ConvergenceState.BORDER), out).to(torch.int32)


def classify(mu, sigma_sq, a, b, epsilon, cfg: RemodeConfig) -> torch.Tensor:
    """``classify_seeds`` with the ``border_mask`` of the image; on the card
    one kernel (``ops/rect_head_cuda``)."""
    if mu.is_cuda:
        return rect_head_cuda.classify(mu, sigma_sq, a, b, epsilon, cfg)
    h, w = mu.shape
    return classify_seeds(mu, sigma_sq, a, b, epsilon, border_mask(h, w, cfg, device=mu.device),
                          cfg)
