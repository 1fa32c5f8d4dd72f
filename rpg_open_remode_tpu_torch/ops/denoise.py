"""Weighted TV-L1 primal-dual depthmap regularizer (Chambolle-Pock).

Counterpart of ``rpg_open_remode_tpu/ops/denoise.py`` (the reference's
``DepthmapDenoiser``, src/depthmap_denoiser.cu): the per-pixel confidence
weight map (computeWeightsKernel, :45-59) and the iterated dual/primal/
extrapolation step (updateTVL1PrimalDualKernel, :61-118). Each half-step is
a whole-array update, so the reference's cross-block race is gone; its
discretization is kept, including differencing ``u_head`` at the neighbour
against ``u`` at the centre (:79-81). The iterations run in the CUDA kernel
of ``ops/denoise_cuda.py`` on the GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from rpg_open_remode_tpu_torch.config import RemodeConfig


def compute_weights(a, b, sigma_sq, large_sigma_sq) -> torch.Tensor:
    """Per-pixel TV weight g >= 1 from seed confidence
    (depthmap_denoiser.cu:56-58)."""
    e_pi = a / (a + b)
    g = (e_pi * sigma_sq + (1.0 - e_pi) * large_sigma_sq) / large_sigma_sq
    return torch.clamp(g, min=1.0)


def _shift_left(x):
    """x[:, j] -> x[:, min(j+1, W-1)] (clamped forward-difference neighbour)."""
    return torch.cat([x[:, 1:], x[:, -1:]], dim=1)


def _shift_up(x):
    return torch.cat([x[1:, :], x[-1:, :]], dim=0)


def _shift_right_zero(x):
    """x[:, j] -> x[:, j-1], 0 at j == 0 (divergence west neighbour)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _shift_down_zero(x):
    return torch.cat([torch.zeros_like(x[:1, :]), x[:-1, :]], dim=0)


def shrink_threshold(lam: float, cfg: RemodeConfig) -> float:
    """tau * lambda, rounded as float32 arithmetic rounds it."""
    return float(np.float32(cfg.tv_tau) * np.float32(lam))


def tvl1_iteration(u, u_head, p_x, p_y, noisy, g, lam: float, cfg: RemodeConfig):
    """One full primal-dual iteration, reference discretization."""
    sigma_d = cfg.tv_sigma
    tau = cfg.tv_tau
    theta = cfg.tv_theta
    h, w = u.shape

    # dual ascent on p (depthmap_denoiser.cu:76-91)
    grad_x = _shift_left(u_head) - u
    grad_y = _shift_up(u_head) - u
    tp_x = g * grad_x * sigma_d + p_x
    tp_y = g * grad_y * sigma_d + p_y
    mag = torch.sqrt(tp_x * tp_x + tp_y * tp_y)
    scale = 1.0 / torch.clamp(mag, min=1.0)
    p_x = tp_x * scale
    p_y = tp_y * scale

    # primal descent on u (depthmap_denoiser.cu:93-112): zero-flux
    # divergence at the domain edge
    col = torch.arange(w, device=u.device)[None, :]
    row = torch.arange(h, device=u.device)[:, None]
    cur_px = torch.where(col >= w - 1, torch.zeros_like(p_x), p_x)
    cur_py = torch.where(row >= h - 1, torch.zeros_like(p_y), p_y)
    div = cur_px - _shift_right_zero(p_x) + cur_py - _shift_down_zero(p_y)

    temp_u = u + tau * g * div
    diff = temp_u - noisy
    thr = shrink_threshold(lam, cfg)
    u_new = torch.where(
        diff > thr, temp_u - thr, torch.where(diff < -thr, temp_u + thr, noisy)
    )
    u_head = u_new + theta * (u_new - u)
    return u_new, u_head, p_x, p_y


def denoise(mu, a, b, sigma_sq, depth_range, cfg: RemodeConfig,
            lam: float | None = None, iterations: int | None = None) -> torch.Tensor:
    """Full denoise pass (DepthmapDenoiser::denoise,
    depthmap_denoiser.cu:179-224); ``large_sigma_sq = depth_range^2 / 72``
    (:226-229)."""
    # imported here: denoise_cuda imports tvl1_iteration from this module
    from rpg_open_remode_tpu_torch.ops import denoise_cuda

    lam = cfg.tv_lambda if lam is None else lam
    iterations = cfg.denoise_iters if iterations is None else iterations
    large_sigma_sq = depth_range * depth_range * cfg.large_sigma_sq_factor
    g = compute_weights(a, b, sigma_sq, large_sigma_sq)
    return denoise_cuda.tvl1(mu.contiguous(), g.contiguous(), lam, iterations, cfg)
