"""Frozen copy of rpg_open_remode_tpu_torch/ops/denoise.py with the plain
TV-L1 loop of ops/denoise_cuda.py: the weighted TV-L1 primal-dual
regularizer of a keyframe's depth."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.config import Config


def compute_weights(a, b, sigma_sq, large_sigma_sq):
    e_pi = a / (a + b)
    g = (e_pi * sigma_sq + (1.0 - e_pi) * large_sigma_sq) / large_sigma_sq
    return torch.clamp(g, min=1.0)


def _shift_left(x):
    return torch.cat([x[:, 1:], x[:, -1:]], dim=1)


def _shift_up(x):
    return torch.cat([x[1:, :], x[-1:, :]], dim=0)


def _shift_right_zero(x):
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _shift_down_zero(x):
    return torch.cat([torch.zeros_like(x[:1, :]), x[:-1, :]], dim=0)


def shrink_threshold(lam: float, cfg: Config) -> float:
    return float(np.float32(cfg.tv_tau) * np.float32(lam))


def tvl1_iteration(u, u_head, p_x, p_y, noisy, g, lam: float, cfg: Config):
    sigma_d = cfg.tv_sigma
    tau = cfg.tv_tau
    theta = cfg.tv_theta
    h, w = u.shape
    grad_x = _shift_left(u_head) - u
    grad_y = _shift_up(u_head) - u
    tp_x = g * grad_x * sigma_d + p_x
    tp_y = g * grad_y * sigma_d + p_y
    mag = torch.sqrt(tp_x * tp_x + tp_y * tp_y)
    scale = 1.0 / torch.clamp(mag, min=1.0)
    p_x = tp_x * scale
    p_y = tp_y * scale
    col = torch.arange(w, device=u.device)[None, :]
    row = torch.arange(h, device=u.device)[:, None]
    cur_px = torch.where(col >= w - 1, torch.zeros_like(p_x), p_x)
    cur_py = torch.where(row >= h - 1, torch.zeros_like(p_y), p_y)
    div = cur_px - _shift_right_zero(p_x) + cur_py - _shift_down_zero(p_y)
    temp_u = u + tau * g * div
    diff = temp_u - noisy
    thr = shrink_threshold(lam, cfg)
    u_new = torch.where(diff > thr, temp_u - thr, torch.where(diff < -thr, temp_u + thr, noisy))
    u_head = u_new + theta * (u_new - u)
    return u_new, u_head, p_x, p_y


def denoise(mu, a, b, sigma_sq, depth_range, cfg: Config, lam: float, iterations: int):
    """``iterations`` TV-L1 steps from u = u_head = mu, p = 0
    (DepthmapDenoiser::denoise, depthmap_denoiser.cu:179-229)."""
    large_sigma_sq = depth_range * depth_range * cfg.large_sigma_sq_factor
    g = compute_weights(a, b, sigma_sq, large_sigma_sq).contiguous()
    noisy = mu.contiguous()
    u = u_head = noisy
    p_x = p_y = torch.zeros_like(noisy)
    for _ in range(iterations):
        u, u_head, p_x, p_y = tvl1_iteration(u, u_head, p_x, p_y, noisy, g, lam, cfg)
    return u
