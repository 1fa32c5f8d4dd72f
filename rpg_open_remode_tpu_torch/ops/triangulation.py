"""Two-view midpoint triangulation and one-pixel-angle depth uncertainty
(counterpart of ``rpg_open_remode_tpu/ops/triangulation.py``; the
reference's src/triangulation.cu:29-68)."""

from __future__ import annotations

import math

import torch

from rpg_open_remode_tpu_torch.utils import se3


def triangulate_midpoint(f_ref, f_curr, T_ref_curr) -> torch.Tensor:
    """3D point in the reference frame, midpoint of the two closest ray
    points (closed form of the 2x2 system, triangulation.cu:36-49)."""
    t = se3.translation(T_ref_curr)
    f2 = se3.rotate(T_ref_curr, f_curr)
    b0 = torch.sum(f_ref * t, dim=-1)
    b1 = torch.sum(f2 * t, dim=-1)
    a00 = torch.sum(f_ref * f_ref, dim=-1)
    a01 = torch.sum(f_ref * f2, dim=-1)
    a10 = -a01
    a11 = -torch.sum(f2 * f2, dim=-1)
    det = a00 * a11 - a10 * a01
    lam0 = (a11 * b0 - a10 * b1) / det
    lam1 = (-a01 * b0 + a00 * b1) / det
    xm = lam0[..., None] * f_ref
    xn = t + lam1[..., None] * f2
    return 0.5 * (xm + xn)


def triangulation_uncertainty(z, f_ref, t_ref_curr, one_pix_angle) -> torch.Tensor:
    """Law-of-sines depth error for a one-pixel match perturbation
    (triangulation.cu:52-68): ``z_plus - z``."""
    a = f_ref * z[..., None] - t_ref_curr
    t_norm = torch.linalg.norm(t_ref_curr)
    a_norm = torch.linalg.norm(a, dim=-1)
    cos_alpha = torch.sum(f_ref * t_ref_curr, dim=-1) / t_norm
    cos_beta = -torch.sum(a * t_ref_curr, dim=-1) / (t_norm * a_norm)
    alpha = torch.arccos(torch.clamp(cos_alpha, -1.0, 1.0))
    beta = torch.arccos(torch.clamp(cos_beta, -1.0, 1.0))
    beta_plus = beta + one_pix_angle
    gamma_plus = math.pi - alpha - beta_plus
    z_plus = t_norm * torch.sin(beta_plus) / torch.sin(gamma_plus)
    return z_plus - z
