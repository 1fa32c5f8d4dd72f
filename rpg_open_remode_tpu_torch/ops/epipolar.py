"""Epipolar NCC matching: the dispatch, the match result, the
inverse-depth plane sweep and the reference-semantics walk (counterpart of
``rpg_open_remode_tpu/ops/epipolar.py``).

``match`` serves ``match_mode`` "rect" (the rectified sweep with its
fallbacks, ``ops/rect_match.match``), "sweep" (``match_planesweep``) and
"walk" (``match_epipolar_walk``, the oracle the fast matchers are held
against).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig
from rpg_open_remode_tpu_torch.models.state import SeedState
from rpg_open_remode_tpu_torch.utils import se3
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera
from rpg_open_remode_tpu_torch.utils.interp import bilinear

_FLT_MIN = 1.1754944e-38  # FLT_MIN, epipolar_match.cu:129
_NEG = -1e30


class MatchResult(NamedTuple):
    found: torch.Tensor     # bool [H, W]: best NCC >= threshold
    u: torch.Tensor         # float [H, W] matched x coord in curr frame
    v: torch.Tensor         # float [H, W] matched y coord in curr frame
    best_ncc: torch.Tensor  # float [H, W]


def apply_match_to_conv(conv, active, found) -> torch.Tensor:
    """Post-match state transition (epipolar_match.cu:131-139): active &
    found -> UPDATE, active & !found -> NO_MATCH, else unchanged."""
    matched = torch.where(
        found, int(ConvergenceState.UPDATE), int(ConvergenceState.NO_MATCH)
    ).to(torch.int32)
    return torch.where(active, matched, conv).to(torch.int32)


def _project_depth(Rf, t, d, cam):
    """Project the point at along-ray depth ``d`` on bearing field ``Rf``
    (rotated into the current frame). Returns (u, v, z)."""
    px = Rf[0] * d + t[0]
    py = Rf[1] * d + t[1]
    pz = Rf[2] * d + t[2]
    return cam.fx * px / pz + cam.cx, cam.fy * py / pz + cam.cy, pz


def plane_set(scene, cfg: RemodeConfig):
    """Shared inverse-depth planes d_k = 1/(inv_lo + k*step) over the scene
    range widened 1.3x."""
    d_min = torch.clamp(scene.min_depth / 1.3, min=cfg.min_search_depth)
    d_max = scene.max_depth * 1.3
    inv_hi = 1.0 / d_min
    inv_lo = 1.0 / d_max
    inv_step = (inv_hi - inv_lo) / (cfg.num_planes - 1)
    return inv_lo, inv_step


def match_planesweep_tile(ref_ext, f_ext, mu, sigma_sq, sum_templ, const_templ_denom,
                          scene, curr_img, T_curr_ref, cam: PinholeCamera,
                          cfg: RemodeConfig) -> MatchResult:
    """Plane sweep over one tile of the seed state: ``ref_ext``/``f_ext``
    carry a p-px halo (p = patch_side // 2), so box sums are 'valid' sums.
    ``ops/planesweep_cuda.planesweep_match``: one kernel launch on the card,
    the plain loop on the CPU."""
    from rpg_open_remode_tpu_torch.ops import planesweep_cuda

    return planesweep_cuda.planesweep_match(ref_ext, f_ext, mu, sigma_sq, sum_templ,
                                            const_templ_denom, scene, curr_img, T_curr_ref,
                                            cam, cfg)


def extend_with_clamp(img: torch.Tensor, p: int) -> torch.Tensor:
    """Edge-replicate halo == CUDA clamp-addressed texture semantics."""
    return torch.nn.functional.pad(img[None, None], (p, p, p, p), mode="replicate")[0, 0]


def bearings_for_grid(cam: PinholeCamera, ys: torch.Tensor, xs: torch.Tensor):
    """Normalized bearings for pixel coordinate vectors, [3, len(ys), len(xs)]."""
    v, u = torch.meshgrid(ys.float(), xs.float(), indexing="ij")
    f = cam.cam2world(u, v)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)
    return torch.movedim(f, -1, 0)


def match_planesweep(state: SeedState, curr_img, T_curr_ref, cam: PinholeCamera,
                     cfg: RemodeConfig) -> MatchResult:
    """The tile sweep on the whole image with a clamped halo."""
    return match_planesweep_tile(*planesweep_args(state, curr_img, T_curr_ref, cam, cfg))


def planesweep_args(state: SeedState, curr_img, T_curr_ref, cam: PinholeCamera,
                    cfg: RemodeConfig) -> tuple:
    """The arguments of ``match_planesweep_tile`` for the whole image: the
    reference image and the bearings extended by a clamped p-px halo."""
    height, width = curr_img.shape
    p = cfg.patch_side // 2
    dev = curr_img.device
    ys = torch.clamp(torch.arange(-p, height + p, device=dev), 0, height - 1)
    xs = torch.clamp(torch.arange(-p, width + p, device=dev), 0, width - 1)
    return (extend_with_clamp(state.ref_img, p), bearings_for_grid(cam, ys, xs),
            state.mu, state.sigma_sq, state.sum_templ, state.const_templ_denom,
            state.scene, curr_img, T_curr_ref, cam, cfg)


def _patch_offsets(cfg: RemodeConfig, device):
    d = torch.arange(cfg.patch_side, dtype=torch.float32, device=device) + cfg.patch_offset
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    return dx.reshape(-1), dy.reshape(-1)  # [P]


def match_epipolar_walk(state: SeedState, curr_img, T_curr_ref, cam: PinholeCamera,
                        cfg: RemodeConfig) -> MatchResult:
    """The reference's per-pixel walk along the epipolar segment
    (seedEpipolarMatchKernel, epipolar_match.cu:37-140) as a fixed trip of
    ``cfg.max_walk_steps`` masked steps of ``epi_step_px``: each step
    gathers every pixel's ``patch_side``-square patch of the current image
    bilinearly ([H, W, P] taps) and keeps a strict ``>`` running best. Plain
    PyTorch on any device; gather-bound, an oracle for tests and checks."""
    height, width = curr_img.shape
    dev = curr_img.device
    area = float(cfg.patch_area)

    R = se3.rotation(T_curr_ref)
    t = se3.translation(T_curr_ref)
    Rf = torch.einsum("ij,jhw->ihw", R, state.f_ref)

    # per-pixel search band (epipolar_match.cu:63-71)
    sigma = torch.sqrt(state.sigma_sq)
    d_lo = torch.clamp(state.mu - cfg.sigma_band * sigma, min=cfg.min_search_depth)
    d_hi = state.mu + cfg.sigma_band * sigma
    u_mean, v_mean, _ = _project_depth(Rf, t, state.mu, cam)
    u_min, v_min, _ = _project_depth(Rf, t, d_lo, cam)
    u_max, v_max, _ = _project_depth(Rf, t, d_hi, cam)

    eu = u_max - u_min
    ev = v_max - v_min
    norm_e = torch.sqrt(eu * eu + ev * ev)
    dir_u = eu / norm_e
    dir_v = ev / norm_e
    half_length = 0.5 * torch.clamp(norm_e, max=cfg.max_epipolar_extent)

    # every pixel's template patch, gathered once: [H, W, P] (integer
    # offsets, so exact clamped reads)
    dx, dy = _patch_offsets(cfg, dev)
    yy, xx = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev),
                            indexing="ij")
    ref_patch = bilinear(state.ref_img, xx[..., None] + dx, yy[..., None] + dy)
    m = float(cfg.patch_side)
    step = np.float32(cfg.epi_step_px)

    best = torch.full((height, width), -1.0, dtype=torch.float32, device=dev)
    bu = torch.zeros((height, width), dtype=torch.float32, device=dev)
    bv = torch.zeros((height, width), dtype=torch.float32, device=dev)
    neg = torch.full_like(best, _NEG)
    for k in range(cfg.max_walk_steps):
        ell = -half_length + float(step * np.float32(k))  # the step in float32
        u_c = u_mean + ell * dir_u
        v_c = v_mean + ell * dir_v
        in_seg = ell <= half_length
        in_img = (u_c >= m) & (u_c < width - m) & (v_c >= m) & (v_c < height - m)
        img_patch = bilinear(curr_img, u_c[..., None] + dx, v_c[..., None] + dy)
        s_i = torch.sum(img_patch, dim=-1)
        s_ii = torch.sum(img_patch * img_patch, dim=-1)
        s_it = torch.sum(img_patch * ref_patch, dim=-1)
        num = area * s_it - s_i * state.sum_templ
        den = (area * s_ii - s_i * s_i) * state.const_templ_denom
        ncc = torch.where(in_seg & in_img, num * torch.rsqrt(den + _FLT_MIN), neg)
        improved = ncc > best
        best = torch.where(improved, ncc, best)
        bu = torch.where(improved, u_c, bu)
        bv = torch.where(improved, v_c, bv)
    return MatchResult(found=best >= cfg.ncc_threshold, u=bu, v=bv, best_ncc=best)


def match(state: SeedState, curr_img, T_curr_ref, cam: PinholeCamera,
          cfg: RemodeConfig, regime: int | None = None, planes: bool = False):
    """The matcher of ``cfg.match_mode``: a ``MatchResult``. The rectified
    one takes the regime index ``regime`` (``rect_match.regime_index``;
    None: read the device's), and with ``planes`` its rectified branch
    returns the back-warped ``rect_match.RectPlanes`` instead."""
    if cfg.match_mode == "walk":
        return match_epipolar_walk(state, curr_img, T_curr_ref, cam, cfg)
    if cfg.match_mode == "sweep":
        return match_planesweep(state, curr_img, T_curr_ref, cam, cfg)
    from rpg_open_remode_tpu_torch.ops import rect_match

    return rect_match.match(state, curr_img, T_curr_ref, cam, cfg, regime, planes)
