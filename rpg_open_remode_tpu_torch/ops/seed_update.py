"""Recursive Bayesian Gaussian x Beta seed update (Vogiatzis-Hernandez).

Counterpart of ``rpg_open_remode_tpu/ops/seed_update.py`` (the reference's
``seedUpdateKernel``, src/seed_update.cu:39-121): triangulate the match into
a depth measurement with a one-pixel-angle uncertainty, then update the
posterior moments; the per-thread branches become ``torch.where``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig
from rpg_open_remode_tpu_torch.models.state import SeedState
from rpg_open_remode_tpu_torch.ops.triangulation import (
    triangulate_midpoint,
    triangulation_uncertainty,
)
from rpg_open_remode_tpu_torch.utils import se3
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera

# expected magnitude of a 3-component zero-mean Gaussian error of per-axis
# sigma: sigma * sqrt(8/pi)
MAG3 = 1.5957691


def _normpdf(x, mu, sigma_sq):
    """Gaussian pdf, as in seed_update.cu:30-37."""
    return torch.exp(-(x - mu) ** 2 / (2.0 * sigma_sq)) * torch.rsqrt(
        2.0 * math.pi * sigma_sq
    )


def update_seeds(
    state: SeedState,
    conv: torch.Tensor,
    match_u: torch.Tensor,
    match_v: torch.Tensor,
    T_ref_curr: torch.Tensor,
    cam: PinholeCamera,
    cfg: RemodeConfig,
) -> SeedState:
    """One measurement-fusion pass. Returns the state with mu/sigma_sq/a/b
    and the stored matches refreshed; ``conv`` is carried through."""
    mu, sigma_sq, a, b = state.mu, state.sigma_sq, state.a, state.b
    f_ref = torch.movedim(state.f_ref, 0, -1)

    # triangulated depth measurement (seed_update.cu:68-88)
    f_curr = cam.cam2world(match_u, match_v)
    f_curr = f_curr / torch.linalg.norm(f_curr, dim=-1, keepdim=True)
    pt_ref = triangulate_midpoint(f_ref, f_curr, T_ref_curr)
    depth = torch.linalg.norm(pt_ref, dim=-1)
    # measurement uncertainty: the one-pixel angle (triangulation.cu:52-68),
    # optionally widened by the configured per-axis VO pose noise
    # (RemodeConfig.pose_noise_*): rotational error adds to the angle,
    # translational error scales depth by the relative baseline error
    t_rc = se3.translation(T_ref_curr)
    angle = cam.one_pix_angle()
    if cfg.pose_noise_rot_deg:
        angle = angle + MAG3 * cfg.pose_noise_rot_deg * (math.pi / 180.0)
    tau = triangulation_uncertainty(depth, f_ref, t_rc, angle)
    tau_sq = tau * tau
    if cfg.pose_noise_trans_m:
        t_norm = torch.clamp(torch.linalg.norm(t_rc), min=1e-6)
        tau_t = depth * (MAG3 * cfg.pose_noise_trans_m / t_norm)
        tau_sq = tau_sq + tau_t * tau_t

    # Gaussian x Beta posterior moment matching (seed_update.cu:89-110)
    s_sq = (tau_sq * sigma_sq) / (tau_sq + sigma_sq)
    m = s_sq * (mu / sigma_sq + depth / tau_sq)
    c1 = (a / (a + b)) * _normpdf(depth, mu, sigma_sq + tau_sq)
    c2 = (b / (a + b)) * (1.0 / state.scene.depth_range)
    norm_const = c1 + c2
    c1 = c1 / norm_const
    c2 = c2 / norm_const
    f = c1 * ((a + 1.0) / (a + b + 1.0)) + c2 * (a / (a + b + 1.0))
    e = c1 * ((a + 1.0) * (a + 2.0)) / ((a + b + 1.0) * (a + b + 2.0)) + c2 * (
        a * (a + 1.0) / ((a + b + 1.0) * (a + b + 2.0))
    )

    mu_new = c1 * m + c2 * mu
    sigma_sq_new = c1 * (s_sq + m * m) + c2 * (sigma_sq + mu * mu) - mu_new * mu_new
    a_new = (e - f) / (f - e / f)
    b_new = a_new * (1.0 - f) / f

    # behind-camera triangulation (seed_update.cu:77-80) and the NaN
    # sentinel (seed_update.cu:100-103) leave the seed untouched
    is_update = conv == int(ConvergenceState.UPDATE)
    valid = is_update & (pt_ref[..., 2] >= 0.0) & ~torch.isnan(c1 * m)
    mu_new = torch.where(valid, mu_new, mu)
    sigma_sq_new = torch.where(valid, sigma_sq_new, sigma_sq)
    a_new = torch.where(valid, a_new, a)
    b_new = torch.where(valid, b_new, b)

    # NO_MATCH: outlier evidence grows (seed_update.cu:113-117)
    no_match = conv == int(ConvergenceState.NO_MATCH)
    b_new = torch.where(no_match, b + 1.0, b_new)

    return dataclasses.replace(
        state,
        mu=mu_new,
        sigma_sq=sigma_sq_new,
        a=a_new,
        b=b_new,
        conv=conv,
        match_u=torch.where(is_update, match_u, state.match_u),
        match_v=torch.where(is_update, match_v, state.match_v),
    )
