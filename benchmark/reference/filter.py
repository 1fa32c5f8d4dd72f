"""Frozen copies of rpg_open_remode_tpu_torch/models/state.py (the state),
ops/seed_check.py, ops/seed_init.py, ops/triangulation.py,
ops/seed_update.py and epipolar.apply_match_to_conv: the per-pixel
Gaussian x Beta depth filter."""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference import geometry as geo
from benchmark.reference.config import BORDER, CONVERGED, DIVERGED, NO_MATCH, UPDATE, Config

_MAG3 = 1.5957691


@dataclasses.dataclass(frozen=True)
class SceneParams:
    min_depth: torch.Tensor
    max_depth: torch.Tensor
    avg_depth: torch.Tensor
    depth_range: torch.Tensor
    sigma_sq_max: torch.Tensor
    epsilon: torch.Tensor

    @classmethod
    def from_bounds(cls, bounds, cfg: Config) -> "SceneParams":
        min_d, max_d = bounds[0], bounds[1]
        rng = max_d - min_d
        return cls(min_depth=min_d, max_depth=max_d, avg_depth=(min_d + max_d) / 2.0,
                   depth_range=rng, sigma_sq_max=rng * rng * cfg.sigma_sq_max_factor,
                   epsilon=rng * cfg.epsilon_factor)


@dataclasses.dataclass(frozen=True)
class SeedState:
    ref_img: torch.Tensor
    sum_templ: torch.Tensor
    const_templ_denom: torch.Tensor
    f_ref: torch.Tensor
    mu: torch.Tensor
    sigma_sq: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    conv: torch.Tensor
    match_u: torch.Tensor
    match_v: torch.Tensor
    T_world_ref: torch.Tensor
    scene: SceneParams


def border_mask(height: int, width: int, cfg: Config, device=None):
    m = cfg.patch_side
    y = torch.arange(height, device=device)[:, None]
    x = torch.arange(width, device=device)[None, :]
    inside = (x >= m) & (x <= width - m - 1) & (y >= m) & (y <= height - m - 1)
    return ~inside


def classify_seeds(mu, sigma_sq, a, b, epsilon, border, cfg: Config):
    e_pi = a / (a + b)
    converged = (e_pi > cfg.eta_inlier) & (sigma_sq < epsilon)
    diverged = (a - 1.0) / (a + b - 2.0) < cfg.eta_outlier
    out = torch.where(diverged, DIVERGED, UPDATE)
    out = torch.where(converged, CONVERGED, out)
    return torch.where(border, BORDER, out).to(torch.int32)


def template_stats(ref_img, cfg: Config):
    side, off, area = cfg.patch_side, cfg.patch_offset, cfg.patch_area
    sum_t = geo.box_sum(ref_img, side, off)
    sum_t_sq = geo.box_sum(ref_img * ref_img, side, off)
    mean_t = sum_t / area
    denom = area * (sum_t_sq - sum_t * mean_t)
    return sum_t, torch.clamp(denom, min=0.0)


def init_seeds(f_ref, ref_img, T_world_ref, scene: SceneParams, cfg: Config) -> SeedState:
    """The flat reseed of a new keyframe (seed_init.cu:56-60)."""
    sum_t, denom = template_stats(ref_img, cfg)
    shape = ref_img.shape
    dev = ref_img.device
    return SeedState(
        ref_img=ref_img, sum_templ=sum_t, const_templ_denom=denom, f_ref=f_ref,
        mu=scene.avg_depth.expand(shape).clone(),
        sigma_sq=scene.sigma_sq_max.expand(shape).clone(),
        a=torch.full(shape, cfg.a_init, dtype=torch.float32, device=dev),
        b=torch.full(shape, cfg.b_init, dtype=torch.float32, device=dev),
        conv=torch.full(shape, UPDATE, dtype=torch.int32, device=dev),
        match_u=torch.zeros(shape, dtype=torch.float32, device=dev),
        match_v=torch.zeros(shape, dtype=torch.float32, device=dev),
        T_world_ref=T_world_ref, scene=scene,
    )


def apply_match_to_conv(conv, active, found):
    matched = torch.where(found, UPDATE, NO_MATCH).to(torch.int32)
    return torch.where(active, matched, conv).to(torch.int32)


def triangulate_midpoint(f_ref, f_curr, T_ref_curr):
    t = geo.translation(T_ref_curr)
    f2 = geo.rotate(T_ref_curr, f_curr)
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


def triangulation_uncertainty(z, f_ref, t_ref_curr, one_pix_angle):
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


def _normpdf(x, mu, sigma_sq):
    return torch.exp(-(x - mu) ** 2 / (2.0 * sigma_sq)) * torch.rsqrt(2.0 * math.pi * sigma_sq)


def update_seeds(state: SeedState, conv, match_u, match_v, T_ref_curr, cam, cfg: Config):
    """One measurement fusion (seed_update.cu:39-121)."""
    mu, sigma_sq, a, b = state.mu, state.sigma_sq, state.a, state.b
    f_ref = torch.movedim(state.f_ref, 0, -1)
    f_curr = cam.cam2world(match_u, match_v)
    f_curr = f_curr / torch.linalg.norm(f_curr, dim=-1, keepdim=True)
    pt_ref = triangulate_midpoint(f_ref, f_curr, T_ref_curr)
    depth = torch.linalg.norm(pt_ref, dim=-1)
    t_rc = geo.translation(T_ref_curr)
    angle = cam.one_pix_angle()
    if cfg.pose_noise_rot_deg:
        angle = angle + _MAG3 * cfg.pose_noise_rot_deg * (math.pi / 180.0)
    tau = triangulation_uncertainty(depth, f_ref, t_rc, angle)
    tau_sq = tau * tau
    if cfg.pose_noise_trans_m:
        t_norm = torch.clamp(torch.linalg.norm(t_rc), min=1e-6)
        tau_t = depth * (_MAG3 * cfg.pose_noise_trans_m / t_norm)
        tau_sq = tau_sq + tau_t * tau_t

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

    is_update = conv == UPDATE
    valid = is_update & (pt_ref[..., 2] >= 0.0) & ~torch.isnan(c1 * m)
    mu_new = torch.where(valid, mu_new, mu)
    sigma_sq_new = torch.where(valid, sigma_sq_new, sigma_sq)
    a_new = torch.where(valid, a_new, a)
    b_new = torch.where(valid, b_new, b)
    no_match = conv == NO_MATCH
    b_new = torch.where(no_match, b + 1.0, b_new)
    return dataclasses.replace(
        state, mu=mu_new, sigma_sq=sigma_sq_new, a=a_new, b=b_new, conv=conv,
        match_u=torch.where(is_update, match_u, state.match_u),
        match_v=torch.where(is_update, match_v, state.match_v),
    )

