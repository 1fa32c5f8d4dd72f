"""Keyframe seed initialization (counterpart of
``rpg_open_remode_tpu/ops/seed_init.py``, the reference's ``seedInitKernel``,
src/seed_init.cu:27-61).

The reference accumulates ``const_templ_denom`` in double precision
(seed_init.cu:53-54) because ``N*sum(t^2) - sum(t)^2`` cancels for flat
patches; like the JAX package, this computes the variance form
``N * (sum_t_sq - sum_t * mean_t)`` in float32 instead.
"""

from __future__ import annotations

import torch

from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig
from rpg_open_remode_tpu_torch.models.state import SceneParams, SeedState
from rpg_open_remode_tpu_torch.utils.interp import box_sum


def template_stats(ref_img: torch.Tensor, cfg: RemodeConfig):
    """Per-pixel NCC template statistics ``(sum_templ, const_templ_denom)``
    of the reference image (seed_init.cu:38-54, clamped borders)."""
    side, off, area = cfg.patch_side, cfg.patch_offset, cfg.patch_area
    sum_t = box_sum(ref_img, side, off)
    sum_t_sq = box_sum(ref_img * ref_img, side, off)
    mean_t = sum_t / area
    denom = area * (sum_t_sq - sum_t * mean_t)
    return sum_t, torch.clamp(denom, min=0.0)


def init_seeds(
    state: SeedState,
    ref_img: torch.Tensor,
    T_world_ref: torch.Tensor,
    scene: SceneParams,
    cfg: RemodeConfig,
    prior=None,
) -> SeedState:
    """Reset the filter on a new reference keyframe (seed_init.cu:56-60).

    ``prior``: optional ``(mu, sigma_sq, a, b, valid)`` warm start (keyframe
    depth propagation, ``ops/propagate.py``); pixels where ``valid`` is not
    set keep the reference's flat initialization."""
    sum_t, denom = template_stats(ref_img, cfg)
    shape = ref_img.shape
    dev = ref_img.device
    mu0 = scene.avg_depth.expand(shape).clone()
    sig0 = scene.sigma_sq_max.expand(shape).clone()
    a0 = torch.full(shape, cfg.a_init, dtype=torch.float32, device=dev)
    b0 = torch.full(shape, cfg.b_init, dtype=torch.float32, device=dev)
    if prior is not None:
        p_mu, p_sig, p_a, p_b, p_valid = prior
        mu0 = torch.where(p_valid, p_mu, mu0)
        sig0 = torch.where(p_valid, p_sig, sig0)
        a0 = torch.where(p_valid, p_a, a0)
        b0 = torch.where(p_valid, p_b, b0)
    return SeedState(
        ref_img=ref_img,
        sum_templ=sum_t,
        const_templ_denom=denom,
        f_ref=state.f_ref,  # bearings depend only on the camera
        mu=mu0,
        sigma_sq=sig0,
        a=a0,
        b=b0,
        conv=torch.full(shape, int(ConvergenceState.UPDATE), dtype=torch.int32, device=dev),
        match_u=torch.zeros(shape, dtype=torch.float32, device=dev),
        match_v=torch.zeros(shape, dtype=torch.float32, device=dev),
        T_world_ref=T_world_ref,
        scene=scene,
    )
