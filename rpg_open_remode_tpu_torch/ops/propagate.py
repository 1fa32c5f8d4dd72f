"""Keyframe-to-keyframe depth propagation (counterpart of
``rpg_open_remode_tpu/ops/propagate.py``; beyond the reference, which
re-seeds every keyframe from the flat prior, seed_init.cu:56-60).

The new keyframe is warm-started from the outgoing keyframe's posterior by
an inverse-depth plane sweep of homography warps:

  1. ``PLANES`` fronto-parallel planes of the old keyframe span the carried
     pixels' inverse-depth range; each plane's homography warps the masked
     posterior stack ``[mu*m, sigma_sq*m, m]`` onto the new grid with the
     two-pass warp (``ops/warp_cuda.homography_warp`` at C=3, the fused
     CUDA kernel on the GPU), ``WARP_CHUNK`` planes a call;
  2. a sample is accepted where it is self-consistent: its depth, in z,
     lies within 0.75 of a plane spacing of the plane that warped it, and
     its analytic source coordinates fall inside the old image;
  3. the sample is lifted along the old ray, moved into the new frame, and
     its along-bearing distance is the prior; the nearest surface wins
     (strict ``d_b < best``, planes in ascending inverse depth);
  4. the exact reprojection must land within ``cfg.propagate_tol_px`` of
     the pixel. Rejected pixels keep the flat prior.

Carried seeds get their own variance inflated ``SIGMA_INFLATE`` times,
floored at ``(propagate_sigma_factor * depth_range)^2``, and restart from
the flat Beta prior (the JAX module's docstring has the measurements behind
these choices).

Device work: the 96 homographies ``H_back = inv(K (R + t n^T / d) K^-1)``
are built in one batched ``torch.linalg.inv_ex`` on the engine's device,
and the plane range stays on the device as 0-d tensors, so the sweep reads
nothing on the host (the per-switch host read of the range is not taken)
and the whole reseed is captured as one CUDA graph
(``models/programs.py``; ``inv_ex`` captures, and its replay equals the
eager call on the H100).
The planes are warped ``WARP_CHUNK`` at a time (one kernel launch a chunk);
each plane then takes some tens of small elementwise ops, in plane order.
"""

from __future__ import annotations

import torch

from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig
from rpg_open_remode_tpu_torch.models.state import SeedState
from rpg_open_remode_tpu_torch.ops import warp_cuda
from rpg_open_remode_tpu_torch.utils import se3
from rpg_open_remode_tpu_torch.utils import warp as warp_ops
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera
from rpg_open_remode_tpu_torch.utils.interp import box_sum

# The JAX module's tuning constants (rpg_open_remode_tpu/ops/propagate.py:68-73)
PLANES = 96            # inverse-depth sweep planes
SIGMA_INFLATE = 4.0    # posterior-variance inflation for the new viewpoint
MIN_INLIER = 0.5       # carry mask: minimum old inlier-ratio mean
NARROW_FRAC = 0.25     # carry mask: sigma_sq below this fraction of max
# planes warped by one launch: ceil(96 / 16) = 6 launches a reseed. A
# chunk's output (C=3) and (u, v) take 16 x 5 float32 planes of the image:
# 98 MB at 640x480, 664 MB at 1920x1080
WARP_CHUNK = 16


def carry_mask(old_state: SeedState) -> torch.Tensor:
    """Seeds with real evidence (CONVERGED, or UPDATE with a narrowed
    variance and inlier ratio > MIN_INLIER), eroded by one pixel so that no
    bilinear sample blends depths across the mask's edge. float32 0/1."""
    inlier = old_state.a / (old_state.a + old_state.b)
    narrowed = old_state.sigma_sq < NARROW_FRAC * old_state.scene.sigma_sq_max
    mask = (
        (old_state.conv == int(ConvergenceState.CONVERGED))
        | ((old_state.conv == int(ConvergenceState.UPDATE))
           & narrowed & (inlier > MIN_INLIER))
    ).float()
    return (box_sum(mask, 3, -1) > 8.5).float()


def plane_homographies(R, t, inv_grid, cam: PinholeCamera) -> torch.Tensor:
    """``[P, 3, 3]`` new-pixel -> old-pixel homographies of the planes
    ``z_old = 1 / inv_grid[k]``, inverted in one batched call."""
    K = warp_ops.intrinsic_matrix(cam)
    K_inv = warp_ops.intrinsic_inv(cam)
    zero = 0.0 * inv_grid
    n_over_d = torch.stack([zero, zero, inv_grid], dim=1)           # [P, 3]
    H_fwd = K @ (R + t[None, :, None] * n_over_d[:, None, :]) @ K_inv
    return torch.linalg.inv_ex(H_fwd)[0]


def propagate_depth(old_state: SeedState, T_curr_world: torch.Tensor, scene,
                    cam: PinholeCamera, cfg: RemodeConfig):
    """-> ``(mu_prior, sigma_sq_prior, a_prior, b_prior, valid)`` on the new
    keyframe's grid. ``T_curr_world`` is the new keyframe's pose (new <-
    world), ``scene`` its SceneParams."""
    height, width = old_state.mu.shape
    dev = old_state.mu.device
    T_BA = se3.compose(T_curr_world, old_state.T_world_ref)       # new <- old
    R = se3.rotation(T_BA)
    t = se3.translation(T_BA)

    conv_mask = carry_mask(old_state)
    stack = torch.stack(
        [old_state.mu * conv_mask, old_state.sigma_sq * conv_mask, conv_mask]
    )

    # inverse-depth planes over the carried pixels' own depth range (the
    # scene bounds are padded), falling back to the scene bounds
    on = conv_mask > 0
    d_min = torch.amin(torch.where(on, old_state.mu, float("inf")))
    d_max = torch.amax(torch.where(on, old_state.mu, float("-inf")))
    d_min = torch.where(torch.isfinite(d_min), d_min, old_state.scene.min_depth)
    d_max = torch.where(torch.isfinite(d_max) & (d_max > d_min), d_max,
                        old_state.scene.max_depth)
    # bounds are ray distances, planes live in z: widen the near bound
    inv_lo = 1.0 / (1.05 * d_max)
    inv_hi = 1.0 / torch.clamp(0.75 * d_min, min=1e-3)
    spacing = (inv_hi - inv_lo) / PLANES
    inv_grid = inv_lo + (torch.arange(PLANES, dtype=torch.float32, device=dev) + 0.5) * spacing
    H_back = plane_homographies(R, t, inv_grid, cam)

    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    yy = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    r = [[R[i, j] for j in range(3)] for i in range(3)]

    best_d = torch.full((height, width), float("inf"), device=dev)
    best_sig = torch.zeros((height, width), device=dev)
    valid = torch.zeros((height, width), dtype=torch.bool, device=dev)
    for k in range(PLANES):
        if k % WARP_CHUNK == 0:
            chunk = warp_cuda.homography_warp(
                stack, H_back[k:k + WARP_CHUNK].contiguous(), height, width)
        warped, u_a, v_a = (x[k % WARP_CHUNK] for x in chunk)
        inv_d = inv_grid[k]
        m_w = torch.clamp(warped[2], min=1e-6)
        mu_s = warped[0] / m_w
        rx = (u_a - cx) / fx
        ry = (v_a - cy) / fy
        norm = torch.sqrt(rx * rx + ry * ry + 1.0)
        # self-consistency in z (mu is an along-ray distance), gated on the
        # analytic source coordinates: the warp clamp-extends at the edges
        in_src = (u_a >= 0.0) & (u_a <= width - 1.0) & (v_a >= 0.0) & (v_a <= height - 1.0)
        z_s = mu_s / norm
        consistent = in_src & (warped[2] > 0.5) & (
            torch.abs(1.0 / torch.clamp(z_s, min=1e-3) - inv_d) <= 0.75 * spacing
        )
        x_a = (rx / norm * mu_s, ry / norm * mu_s, 1.0 / norm * mu_s)
        # R @ x_a + t as explicit products and sums
        x_b = [r[i][0] * x_a[0] + r[i][1] * x_a[1] + r[i][2] * x_a[2] + t[i]
               for i in range(3)]
        d_b = torch.sqrt(x_b[0] * x_b[0] + x_b[1] * x_b[1] + x_b[2] * x_b[2])
        z_b = x_b[2]
        z_safe = torch.clamp(z_b, min=1e-6)
        u_b = fx * x_b[0] / z_safe + cx
        v_b = fy * x_b[1] / z_safe + cy
        err = torch.hypot(u_b - xx, v_b - yy)
        ok = (
            consistent
            & (z_b > 1e-3)
            & (err < cfg.propagate_tol_px)
            & (d_b > scene.min_depth)
            & (d_b < scene.max_depth)
        )
        # nearest surface wins
        better = ok & (d_b < best_d)
        best_d = torch.where(better, d_b, best_d)
        best_sig = torch.where(better, warped[1] / m_w, best_sig)
        valid = valid | ok

    floor_sq = torch.square(cfg.propagate_sigma_factor * scene.depth_range)
    sigma_sq = torch.maximum(SIGMA_INFLATE * best_sig, floor_sq)
    # flat Beta prior: carrying evidence was measured harmful (JAX docstring)
    a_p = torch.full((height, width), cfg.a_init, dtype=torch.float32, device=dev)
    b_p = torch.full((height, width), cfg.b_init, dtype=torch.float32, device=dev)
    mu_p = torch.clamp(torch.where(valid, best_d, scene.avg_depth),
                       scene.min_depth, scene.max_depth)
    return mu_p, sigma_sq, a_p, b_p, valid
