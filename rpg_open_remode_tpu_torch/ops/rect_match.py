"""Rectified disparity-sweep NCC matcher (counterpart of
``rpg_open_remode_tpu/ops/rect_match.py``).

Per frame: rotate both cameras onto a common rectified frame whose x-axis
is the baseline, so epipolar lines become scanlines and every depth
hypothesis becomes a horizontal shift of the rectified current image; warp
the reference stack and the current frame onto the rect grid (two-pass
homography warps); sweep integer disparities inside each pixel's Bayesian
band (``ops/sweep_cuda``, a CUDA kernel on the GPU); back-warp the found
matches and unrectify them. On the GPU the step's head around those warps
and sweeps, up to the back-warp, runs as the hand kernels of
``ops/rect_head_cuda``: ``prepare_sweep`` chains pieces that each run their
plain version on the CPU and their kernel on the GPU.

The JAX package's two traced branches are decided without a host read of
the device, so that a frame step can be captured as one CUDA graph
(``models/programs.py``):

  * the coarse-pass gate (``lax.cond``) stays a 0-d bool on the device: the
    coarse sweep is launched on every rectified frame with a pointer to it,
    returns "not found" everywhere when it is off, and ``_coarse_narrow``
    selects the narrowed bands only where it is on;
  * the matcher (``lax.switch``) is chosen on the host by ``regime_index``
    from host copies of the poses and the scene's mean depth, in the
    device's float32 order of operations, and ``match`` runs that branch.
    ``regime_device`` is the same choice computed on the device (the
    oracle; ``match`` reads it when no regime is given).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig
from rpg_open_remode_tpu_torch.models.state import SeedState
from rpg_open_remode_tpu_torch.ops import epipolar, rect_head_cuda
from rpg_open_remode_tpu_torch.ops.epipolar import MatchResult
from rpg_open_remode_tpu_torch.ops.sweep_cuda import box_zero, disparity_sweep
from rpg_open_remode_tpu_torch.utils import se3
from rpg_open_remode_tpu_torch.utils import warp as warp_ops
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera


_FLT_MIN = 1.1754944e-38


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def rect_shape(height: int, width: int) -> tuple[int, int]:
    """Rect-grid shape. It sets the rect focal scale, so it stays exactly
    the JAX package's (mild headroom over the image, rounded up)."""
    return _round_up(height + 32, 64), _round_up(width + 64, 128)


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, device) -> torch.Tensor:
    """A small float32 constant on ``device``, uploaded once (at a step's
    first, eager run) and then shared: an upload inside a CUDA graph capture
    is not allowed, and one per frame would be a host sync."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _corners(height, width, order: str, device) -> torch.Tensor:
    """Homogeneous image-corner matrix [4, 3]. order 'zigzag' =
    (0,0),(W,0),(0,H),(W,H); 'ring' = (0,0),(W,0),(W,H),(0,H)."""
    w1, h1 = width - 1.0, height - 1.0
    pts = ([(0.0, 0.0), (w1, 0.0), (0.0, h1), (w1, h1)] if order == "zigzag"
           else [(0.0, 0.0), (w1, 0.0), (w1, h1), (0.0, h1)])
    return _constant(tuple((x, y, 1.0) for x, y in pts), torch.device(device))


def _rect_rotation(C: torch.Tensor) -> torch.Tensor:
    """Rows [e1; e2; e3] of the rectifying rotation: x-axis along the
    baseline C, z-axis as close to the reference optical axis as possible
    (Fusiello's construction)."""
    B = torch.linalg.norm(C)
    e1 = C / torch.clamp(B, min=1e-12)
    z = _constant((0.0, 0.0, 1.0), C.device)
    y_alt = _constant((0.0, 1.0, 0.0), C.device)
    e2 = torch.linalg.cross(z, e1)
    n2 = torch.linalg.norm(e2)
    # forward motion (baseline ~ optical axis): fall back to the camera y-axis
    e2 = torch.where(n2 > 1e-3, e2 / torch.clamp(n2, min=1e-12), y_alt)
    e2 = e2 - torch.dot(e2, e1) * e1
    e2 = e2 / torch.clamp(torch.linalg.norm(e2), min=1e-12)
    e3 = torch.linalg.cross(e1, e2)
    return torch.stack([e1, e2, e3])


def _fit_rect_intrinsics(R_rect, cam, height, width, rect_h, rect_w):
    """Rect intrinsics (s, sx, sy, cx', cy') fitting the reference footprint
    onto the rect grid; the scales carry the signs of the source focal
    lengths so the rect grid keeps the image's orientation."""
    corners = _corners(height, width, "zigzag", R_rect.device)
    rays = corners @ warp_ops.intrinsic_inv(cam).T
    Y = rays @ R_rect.T
    xh = Y[:, 0] / Y[:, 2]
    yh = Y[:, 1] / Y[:, 2]
    sx_m = (rect_w - 1.0) / torch.clamp(xh.max() - xh.min(), min=1e-6)
    sy_m = (rect_h - 1.0) / torch.clamp(yh.max() - yh.min(), min=1e-6)
    s = torch.minimum(sx_m, sy_m)
    sx = torch.sign(cam.fx) * s
    sy = torch.sign(cam.fy) * s
    cx = -torch.minimum(sx * xh.min(), sx * xh.max())
    cy = -torch.minimum(sy * yh.min(), sy * yh.max())
    return s, sx, sy, cx, cy


def _kmat(sx, sy, cx, cy):
    z = torch.zeros_like(sx)
    o = torch.ones_like(sx)
    return torch.stack([torch.stack([sx, z, cx]), torch.stack([z, sy, cy]),
                        torch.stack([z, z, o])])


def _kmat_inv(sx, sy, cx, cy):
    z = torch.zeros_like(sx)
    o = torch.ones_like(sx)
    ix = 1.0 / sx
    iy = 1.0 / sy
    return torch.stack([torch.stack([ix, z, -cx * ix]), torch.stack([z, iy, -cy * iy]),
                        torch.stack([z, z, o])])


def _window_extreme(x: torch.Tensor, n: int, fn, fill: float) -> torch.Tensor:
    """'same' sliding min/max of odd width ``n`` over a 1-D tensor."""
    hp = n // 2
    p = torch.cat([x.new_full((hp,), fill), x, x.new_full((n - 1 - hp,), fill)])
    return fn(p.unfold(0, n, 1), dim=1).values


def _footprint_xlim(H_img_to_rect, height, width, rect_h, reach=3.5, vrows=5):
    """Exact per-rect-row x-interval of the warped image footprint (a
    convex quad meets a scanline in an interval), eroded by ``reach`` px
    horizontally and ``vrows // 2`` rows vertically. Returns [rect_h, 2];
    empty rows have min > max."""
    corners = _corners(height, width, "ring", H_img_to_rect.device)
    pc = corners @ H_img_to_rect.T
    px = pc[:, 0] / pc[:, 2]
    py = pc[:, 1] / pc[:, 2]
    qx = torch.roll(px, -1)
    qy = torch.roll(py, -1)

    y = torch.arange(rect_h, dtype=torch.float32, device=px.device)[:, None]
    dy = qy[None, :] - py[None, :]
    t = (y - py[None, :]) / torch.where(torch.abs(dy) < 1e-12, torch.full_like(dy, 1e-12), dy)
    crossing = (t >= 0.0) & (t <= 1.0)
    x_at = px[None, :] + t * (qx[None, :] - px[None, :])
    inf = torch.full_like(x_at, float("inf"))
    xmin = torch.min(torch.where(crossing, x_at, inf), dim=1).values
    xmax = torch.max(torch.where(crossing, x_at, -inf), dim=1).values
    xmin_e = _window_extreme(xmin, vrows, torch.max, float("-inf")) + reach
    xmax_e = _window_extreme(xmax, vrows, torch.min, float("inf")) - reach
    return torch.stack([xmin_e, xmax_e], dim=1)


def coarse_sweep_args(curr_pad, ref_img_r, valid_r, xlim, disp_lo, disp_hi,
                      cfg: RemodeConfig) -> tuple:
    """The coarse pass's ``disparity_sweep`` arguments: the x-decimated
    half-resolution grid of the full pass's inputs, each half pixel's band
    the union of its two full pixels' bands."""
    pad_h = cfg.disp_pad // 2
    planes_h = min(pad_h - 1, cfg.num_planes // 2 + 1)
    # x-only 2:1 box decimation: half-disparity k_h is full disparity 2 k_h
    curr_h = (0.5 * (curr_pad[:, ::2] + curr_pad[:, 1::2])).contiguous()
    ref_h = (0.5 * (ref_img_r[:, ::2] + ref_img_r[:, 1::2])).contiguous()
    valid_h = torch.minimum(valid_r[:, ::2], valid_r[:, 1::2]).contiguous()
    # NCC taps span patch//2 HALF pixels here: scale the footprint margin
    hp_margin = 0.5 * (cfg.patch_side // 2) + 1.0
    xlim_h = torch.stack(
        [xlim[:, 0] * 0.5 + hp_margin, xlim[:, 1] * 0.5 - hp_margin], dim=1
    ).contiguous()
    lo_h = (torch.minimum(disp_lo[:, ::2], disp_lo[:, 1::2]) * 0.5).contiguous()
    hi_h = (torch.maximum(disp_hi[:, ::2], disp_hi[:, 1::2]) * 0.5).contiguous()
    return (curr_h, xlim_h, ref_h, valid_h, lo_h, hi_h, cfg.ncc_threshold,
            planes_h, pad_h, cfg.patch_side, False)


def _coarse_narrow(coarse_args, disp_lo, disp_hi, cfg: RemodeConfig, gate=None):
    """Coarse-to-fine: localize each pixel's NCC peak on the half-resolution
    grid (``coarse_sweep_args``), then shrink its band to
    +-coarse_refine_radius planes around the peak. Pixels the coarse pass
    cannot place keep their full band. ``gate`` (a 0-d bool on the device;
    None: on) is the JAX package's ``lax.cond``: the sweep skips its work
    when it is off, and every band is then kept as it was."""
    d_c, _, found_c = disparity_sweep(*coarse_args, gate=gate)
    return narrow_bands_plain(d_c, found_c, disp_lo, disp_hi, cfg, gate)


def narrow_bands_plain(d_c, found_c, disp_lo, disp_hi, cfg: RemodeConfig, gate=None):
    """``_coarse_narrow`` after its sweep: each band shrunk to
    +-coarse_refine_radius planes around the coarse peak ``d_c`` where the
    coarse pass found one (``found_c``) and ``gate`` is on."""
    d_up = torch.repeat_interleave(2.0 * d_c, 2, dim=1)
    f_up = torch.repeat_interleave(found_c, 2, dim=1)
    r = cfg.coarse_refine_radius
    lo2 = torch.maximum(disp_lo, d_up - r)
    hi2 = torch.minimum(disp_hi, d_up + r)
    ok = f_up & (lo2 <= hi2)
    if gate is not None:
        ok = ok & gate   # torch.where(gate, narrowed, unnarrowed)
    return torch.where(ok, lo2, disp_lo), torch.where(ok, hi2, disp_hi)


def narrow_bands(d_c, found_c, disp_lo, disp_hi, cfg: RemodeConfig, gate):
    """``narrow_bands_plain``; on the card one kernel, which narrows
    ``disp_lo`` and ``disp_hi`` in place."""
    if disp_lo.is_cuda:
        return rect_head_cuda.coarse_narrow(d_c, found_c, disp_lo, disp_hi, cfg, gate)
    return narrow_bands_plain(d_c, found_c, disp_lo, disp_hi, cfg, gate)


def straggler_flag(a: torch.Tensor, b: torch.Tensor, cfg: RemodeConfig):
    """Per-seed straggler predicate and fruitless-frame count: at least
    ``straggler_after`` net outlier pseudo-counts while the inlier-ratio
    mean is below 0.45."""
    fruitless = b - cfg.b_init
    flag = (fruitless >= cfg.straggler_after) & (a / (a + b) < 0.45)
    return flag.float(), fruitless


def straggler_slice_bands(d_lo, d_hi, mu, strag, n_est, fxB, cfg: RemodeConfig):
    """Slice stragglers' search bands to a rotating window of
    S = 2 * coarse_refine_radius + 2 planes in inverse depth: two frames
    out of three a golden-ratio-stepped exploration window over the
    extent-capped band, every third frame a window centred on mu. The phase
    comes from ``n_est``, the image-wide maximum fruitless count, so it is
    the same for every pixel. Returns (d_lo', d_hi', d_center)."""
    S_pl = 2.0 * cfg.coarse_refine_radius + 2.0
    fxB = torch.clamp(fxB, min=1e-6)
    i_lo = 1.0 / d_hi
    i_hi = 1.0 / d_lo
    i_mu0 = 1.0 / torch.clamp(mu, d_lo, d_hi)
    half = 0.5 * torch.clamp((i_hi - i_lo) * fxB, max=cfg.max_epipolar_extent) / fxB
    i_lo = torch.maximum(i_lo, i_mu0 - half)
    i_hi = torch.minimum(i_hi, i_mu0 + half)
    Wi = i_hi - i_lo
    Si = S_pl / fxB
    sliced = (strag > 0.5) & (Wi > Si)
    phase = 0.6180339887 * n_est
    phi = phase - torch.floor(phase)
    exploit = torch.remainder(torch.floor(n_est), 3.0) < 0.5
    lo_explore = i_lo + phi * (Wi - Si)
    lo_center = torch.minimum(torch.maximum(i_mu0 - 0.5 * Si, i_lo), i_hi - Si)
    lo_s = torch.where(exploit, lo_center, lo_explore)
    hi_s = lo_s + Si
    d_lo2 = torch.where(sliced, 1.0 / hi_s, d_lo)
    d_hi2 = torch.where(sliced, 1.0 / lo_s, d_hi)
    d_center = torch.where(sliced, 2.0 / (lo_s + hi_s), mu)
    return d_lo2, d_hi2, d_center


def rect_geometry(T_curr_ref, cam: PinholeCamera, height: int, width: int) -> dict:
    """Per-frame rectification geometry: relative rotation/baseline, the
    rectifying rotation, the fitted rect intrinsics and the homographies
    between the ref, current and rect grids."""
    rect_h, rect_w = rect_shape(height, width)
    R = se3.rotation(T_curr_ref)
    t = se3.translation(T_curr_ref)
    C = -R.T @ t
    B = torch.linalg.norm(C)
    Kc = warp_ops.intrinsic_matrix(cam)
    Kc_inv = warp_ops.intrinsic_inv(cam)
    # orient the rect x-axis so disparity comes out positive whatever the
    # sign of fx
    R_rect = _rect_rotation(torch.sign(cam.fx) * C)
    s, sxr, syr, cxr, cyr = _fit_rect_intrinsics(R_rect, cam, height, width, rect_h, rect_w)
    Kr = _kmat(sxr, syr, cxr, cyr)
    Kr_inv = _kmat_inv(sxr, syr, cxr, cyr)
    return dict(
        rect_h=rect_h, rect_w=rect_w, R=R, t=t, C=C, B=B, s=s,
        H_rect_to_ref=Kc @ R_rect.T @ Kr_inv,
        H_rect_to_curr=Kc @ R @ R_rect.T @ Kr_inv,
        H_curr_to_rect=Kr @ R_rect @ R.T @ Kc_inv,
        H_ref_to_rect=Kr @ R_rect @ Kc_inv,
        R_rect=R_rect,
    )


# -- the head of a rectified step, cut where its kernels are cut --------------
# Each piece runs its plain version (``*_plain``) on CPU tensors and its
# hand kernel (``ops/rect_head_cuda``) on CUDA tensors; ``prepare_sweep``
# and ``match_rectified_planes`` chain them with the warps and sweeps.


def geometry_plain(T_curr_ref, cam: PinholeCamera, height: int, width: int,
                   cfg: RemodeConfig):
    """``(g, xlim)``: ``rect_geometry`` and each rect row's footprint
    interval (``_footprint_xlim``), not yet rebased."""
    g = rect_geometry(T_curr_ref, cam, height, width)
    xlim = _footprint_xlim(
        g["H_curr_to_rect"], height, width, g["rect_h"],
        reach=cfg.patch_side // 2 + 1.5, vrows=cfg.patch_side,
    )
    return g, xlim


def geometry(T_curr_ref, cam: PinholeCamera, height: int, width: int, cfg: RemodeConfig):
    """``geometry_plain``; on the card one kernel, whose ``g`` also holds the
    device buffers the later pieces' kernels share (``"geo"``, ``"acc"``)."""
    if T_curr_ref.is_cuda:
        return rect_head_cuda.geometry(T_curr_ref, cam, height, width,
                                       *rect_shape(height, width), cfg)
    return geometry_plain(T_curr_ref, cam, height, width, cfg)


def ref_bands_plain(state: SeedState, g: dict, cfg: RemodeConfig) -> torch.Tensor:
    """The reference warp's input [5, H, W]: the keyframe image, the band's
    low, centre and high depths as z along the rect axis (the Bayesian band,
    stragglers' sliced), and the UPDATE mask."""
    sigma = torch.sqrt(state.sigma_sq)
    d_lo = torch.clamp(state.mu - cfg.sigma_band * sigma, min=cfg.min_search_depth)
    d_hi = state.mu + cfg.sigma_band * sigma
    d_center = state.mu
    if cfg.straggler_slice:
        strag, fruitless = straggler_flag(state.a, state.b, cfg)
        d_lo, d_hi, d_center = straggler_slice_bands(
            d_lo, d_hi, state.mu, strag, torch.max(fruitless), torch.abs(g["s"]) * g["B"], cfg,
        )
    rz = torch.einsum("j,jhw->hw", g["R_rect"][2], state.f_ref)
    rz = torch.clamp(rz, min=1e-3)
    z_floor = 1e-4
    # only UPDATE seeds are matched (epipolar_match.cu:51-57)
    active = (state.conv == int(ConvergenceState.UPDATE)).float()
    return torch.stack([
        state.ref_img,
        torch.clamp(d_lo * rz, min=z_floor),
        torch.clamp(d_center * rz, min=z_floor),
        torch.clamp(d_hi * rz, min=z_floor),
        active,
    ])


def ref_bands(state: SeedState, g: dict, cfg: RemodeConfig) -> torch.Tensor:
    """``ref_bands_plain``; on the card two kernels."""
    if state.mu.is_cuda:
        return rect_head_cuda.ref_bands(state, g["geo"], g["acc"], cfg)
    return ref_bands_plain(state, g, cfg)


def rect_bands_plain(ref_r, u_s, v_s, g: dict, height: int, width: int, cfg: RemodeConfig):
    """``(valid_r, disp_lo, disp_hi, kbase, H_shift)`` from the warped
    reference stack and its sample coordinates: the ref-footprint validity,
    each rect pixel's disparity band (the Bayesian band intersected with the
    extent cap, an empty interval where inactive), the rebasing constant and
    ``H_rect_to_curr`` shifted by it."""
    _, z_lo_r, z_mu_r, z_hi_r, act_r = ref_r.unbind(0)
    # ref-footprint validity is analytic: the resampler clamp-extends
    valid_r = (
        (u_s >= 0.0) & (u_s <= width - 1.0) & (v_s >= 0.0) & (v_s <= height - 1.0)
    ).float()

    # per-pixel disparity bands: disparity = |s| B / z
    fxB = torch.abs(g["s"]) * g["B"]
    disp_lo = fxB / z_hi_r
    disp_hi = fxB / z_lo_r
    disp_mu = fxB / z_mu_r
    half_len = 0.5 * torch.clamp(disp_hi - disp_lo, max=cfg.max_epipolar_extent)
    disp_lo = torch.maximum(disp_lo, disp_mu - half_len)
    disp_hi = torch.minimum(disp_hi, disp_mu + half_len)

    # inactive rect pixels get an empty interval
    act = act_r > 1e-3
    inf = torch.full_like(disp_lo, float("inf"))
    disp_lo = torch.where(act, disp_lo, inf)
    disp_hi = torch.where(act, disp_hi, -inf)

    # constant disparity rebasing: the K-plane window covers
    # [kbase, kbase + K), folded into the current-frame warp as an
    # x-translation
    dev = disp_lo.device
    if cfg.disp_rebase:
        lo_valid = torch.where(valid_r > 0.999, disp_lo, inf)
        base_raw = torch.floor(torch.min(lo_valid)) - 1.0
        kbase = torch.where(
            torch.isfinite(base_raw), torch.clamp(base_raw, min=0.0),
            torch.zeros_like(base_raw),
        )
    else:
        kbase = torch.zeros((), dtype=torch.float32, device=dev)
    z = torch.zeros((), dtype=torch.float32, device=dev)
    o = torch.ones((), dtype=torch.float32, device=dev)
    M_aff = torch.stack([torch.stack([o, z, -kbase]), torch.stack([z, o, z]),
                         torch.stack([z, z, o])])
    return valid_r, disp_lo, disp_hi, kbase, g["H_rect_to_curr"] @ M_aff


def rect_bands(ref_r, u_s, v_s, g: dict, height: int, width: int, cfg: RemodeConfig):
    """``rect_bands_plain``; on the card one kernel."""
    if ref_r.is_cuda:
        return rect_head_cuda.rect_bands(ref_r, u_s, v_s, g["geo"], g["acc"], height, width,
                                         cfg)
    return rect_bands_plain(ref_r, u_s, v_s, g, height, width, cfg)


def rebase_plain(curr_img_r, ref_img_r, valid_r, disp_lo, disp_hi, xlim, kbase,
                 cfg: RemodeConfig):
    """``(k_lo, k_hi, xlim, coarse_args, gate)``: the bands and the footprint
    interval in rebased disparity, and, with ``cfg.coarse_to_fine``, the
    coarse pass's arguments and its 0-d bool gate on the device (else None,
    None)."""
    k_lo = disp_lo - kbase
    k_hi = disp_hi - kbase
    xlim = xlim + kbase
    coarse_args = gate = None
    if cfg.coarse_to_fine:
        # pay the coarse pass only while wide bands cover a meaningful
        # fraction of the image (young keyframes): the gate stays on the
        # device, the arguments are always built, and the kernel skips its
        # work when the gate is off
        extent = k_hi - k_lo
        wide_n = torch.isfinite(extent) & (extent > 2.0 * cfg.coarse_refine_radius + 2.0)
        gate = wide_n.float().mean() > 0.15
        coarse_args = coarse_sweep_args(curr_img_r, ref_img_r, valid_r, xlim, k_lo, k_hi, cfg)
    return k_lo, k_hi, xlim, coarse_args, gate


def rebase(curr_img_r, ref_img_r, valid_r, disp_lo, disp_hi, xlim, kbase, g: dict,
           cfg: RemodeConfig):
    """``rebase_plain``; on the card one kernel, which rebases ``disp_lo``
    and ``disp_hi`` in place and reads ``kbase`` from ``g``'s buffer."""
    if valid_r.is_cuda:
        return rect_head_cuda.rect_rebase(curr_img_r, ref_img_r, valid_r, disp_lo, disp_hi,
                                          xlim, g["geo"], g["acc"], cfg)
    return rebase_plain(curr_img_r, ref_img_r, valid_r, disp_lo, disp_hi, xlim, kbase, cfg)


def prepare_sweep(state: SeedState, curr_img, T_curr_ref, cam: PinholeCamera,
                  cfg: RemodeConfig) -> dict:
    """Everything ``match_rectified`` does before the full sweep:
    rectification warps, footprint interval, per-pixel disparity bands
    (Bayesian band intersected with the extent cap), disparity rebasing and
    the coarse-to-fine narrowing. Returns the sweep inputs, under
    ``coarse_args`` the coarse pass's arguments and under ``gate`` its 0-d
    bool gate on the device (both None without ``cfg.coarse_to_fine``)."""
    height, width = curr_img.shape
    pad = cfg.disp_pad
    g, xlim = geometry(T_curr_ref, cam, height, width, cfg)
    rect_h, rect_w = g["rect_h"], g["rect_w"]
    ref_r, u_s, v_s = warp_ops.homography_warp(ref_bands(state, g, cfg), g["H_rect_to_ref"],
                                               rect_h, rect_w)
    ref_img_r = ref_r[0]
    valid_r, disp_lo, disp_hi, kbase, H_shift = rect_bands(ref_r, u_s, v_s, g, height, width,
                                                           cfg)
    # the pad stays an exact integer output-origin shift, outside the product
    curr_img_r, _, _ = warp_ops.homography_warp(
        curr_img, H_shift, rect_h, rect_w + 2 * pad, x0=-float(pad), want_uv=False,
    )
    disp_lo, disp_hi, xlim, coarse_args, gate = rebase(
        curr_img_r, ref_img_r, valid_r, disp_lo, disp_hi, xlim, kbase, g, cfg)
    if coarse_args is not None:
        d_c, _, found_c = disparity_sweep(*coarse_args, gate=gate)
        disp_lo, disp_hi = narrow_bands(d_c, found_c, disp_lo, disp_hi, cfg, gate)

    return dict(
        g=g, curr_img_r=curr_img_r.contiguous(), ref_img_r=ref_img_r.contiguous(),
        valid_r=valid_r.contiguous(), xlim=xlim.contiguous(),
        disp_lo=disp_lo.contiguous(), disp_hi=disp_hi.contiguous(), kbase=kbase,
        coarse_args=coarse_args, gate=gate,
    )


class RectPlanes(NamedTuple):
    """The rectified matcher stopped at the back-warp: ``back`` [3, H, W]
    (found-masked disparity, found-masked NCC and the found weight, warped
    onto the reference grid) and the two homographies ``unrectify`` needs."""

    back: torch.Tensor
    H_ref_to_rect: torch.Tensor
    H_rect_to_curr: torch.Tensor


def match_rectified_planes(state: SeedState, curr_img, T_curr_ref, cam: PinholeCamera,
                           cfg: RemodeConfig) -> RectPlanes:
    """``match_rectified`` up to and including the back-warp."""
    height, width = curr_img.shape
    p = prepare_sweep(state, curr_img, T_curr_ref, cam, cfg)
    g = p["g"]
    disp_best, best, found_r = disparity_sweep(
        p["curr_img_r"], p["xlim"], p["ref_img_r"], p["valid_r"],
        p["disp_lo"], p["disp_hi"], cfg.ncc_threshold, cfg.num_planes,
        cfg.disp_pad, cfg.patch_side, cfg.subplane_refine,
    )

    back, _, _ = warp_ops.homography_warp(back_stack(disp_best, best, found_r, p["kbase"]),
                                          g["H_ref_to_rect"], height, width, want_uv=False)
    return RectPlanes(back, g["H_ref_to_rect"], g["H_rect_to_curr"])


def back_stack_plain(disp, ncc, found, kbase) -> torch.Tensor:
    """The back-warp's input [3, H, W]: the rebased disparity and the NCC,
    found-masked so that ``unrectify`` can renormalize and the -10 not-found
    sentinel never mixes into a match, and the found weight."""
    found_f = found.float()
    return torch.stack([(disp + kbase) * found_f, ncc * found_f, found_f])


def back_stack(disp, ncc, found, kbase) -> torch.Tensor:
    """``back_stack_plain``; on the card one kernel."""
    if disp.is_cuda:
        return rect_head_cuda.back_stack(disp, ncc, found, kbase)
    return back_stack_plain(disp, ncc, found, kbase)


def unrectify(planes: RectPlanes, cfg: RemodeConfig) -> MatchResult:
    """The rest of ``match_rectified``, per reference pixel: renormalize the
    back-warped planes, then map each match (x_r - disp, y_r) on the rect
    grid into the current image."""
    back = planes.back
    height, width = back.shape[-2:]
    found_b = back[2]
    wgt = torch.clamp(found_b, min=1e-6)
    disp_b = back[0] / wgt
    ncc_b = back[1] / wgt

    dev = back.device
    yy = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    xr, yr = warp_ops.homography_coords(planes.H_ref_to_rect, xx, yy)

    # match position in the current image: unrectify (x_r - disp, y_r)
    Hc = planes.H_rect_to_curr
    uc_r = xr - disp_b
    den_c = Hc[2, 0] * uc_r + Hc[2, 1] * yr + Hc[2, 2]
    den_c = torch.where(torch.abs(den_c) < 1e-8, torch.full_like(den_c, 1e-8), den_c)
    u_c = (Hc[0, 0] * uc_r + Hc[0, 1] * yr + Hc[0, 2]) / den_c
    v_c = (Hc[1, 0] * uc_r + Hc[1, 1] * yr + Hc[1, 2]) / den_c

    found = (found_b > 0.5) & (ncc_b >= cfg.ncc_threshold)
    return MatchResult(found=found, u=u_c, v=v_c, best_ncc=torch.clamp(ncc_b, -1.0, 1.0))


def match_rectified(state: SeedState, curr_img, T_curr_ref, cam: PinholeCamera,
                    cfg: RemodeConfig) -> MatchResult:
    return unrectify(match_rectified_planes(state, curr_img, T_curr_ref, cam, cfg), cfg)


def match_pure_rotation(state: SeedState, curr_img, T_curr_ref, cam: PinholeCamera,
                        cfg: RemodeConfig) -> MatchResult:
    """Near-zero baseline: depth is unobservable, so match through the
    infinite-plane homography K R K^-1 (identity motion self-matches every
    pixel, test/epipolar_test.cpp:206-220)."""
    height, width = curr_img.shape
    side = cfg.patch_side
    area = float(cfg.patch_area)
    H_inf, _ = warp_ops.infinite_homography(
        se3.rotation(T_curr_ref), se3.translation(T_curr_ref), cam
    )
    img, u, v = warp_ops.homography_warp(curr_img, H_inf, height, width)
    s_i = box_zero(img, side)
    s_ii = box_zero(img * img, side)
    s_it = box_zero(img * state.ref_img, side)
    num = area * s_it - s_i * state.sum_templ
    den = (area * s_ii - s_i * s_i) * state.const_templ_denom
    ncc = num * torch.rsqrt(torch.clamp(den, min=_FLT_MIN))
    vv = ((u >= 0.0) & (u <= width - 1.0) & (v >= 0.0) & (v <= height - 1.0)).float()
    ok = box_zero(vv, side) > (area - 0.5)
    m = float(side)
    ok &= (u >= m) & (u < width - m) & (v >= m) & (v < height - m)
    found = ok & (ncc >= cfg.ncc_threshold)
    return MatchResult(found=found, u=u, v=v,
                       best_ncc=torch.where(ok, ncc, torch.full_like(ncc, -1.0)))


# matcher branches of ``match``, by regime index (the JAX lax.switch order)
PURE_ROTATION, PLANE_SWEEP, RECTIFIED = 0, 1, 2


def regime_device(state: SeedState, T_curr_ref, cam: PinholeCamera, cfg: RemodeConfig,
                  height: int, width: int) -> torch.Tensor:
    """The matcher branch as a 0-d int64 tensor on the device: near-zero
    baseline -> PURE_ROTATION; an epipole inside/near either image
    footprint (axial motion) -> PLANE_SWEEP; else RECTIFIED."""
    if not cfg.zero_baseline_fallback:
        return torch.full((), RECTIFIED, dtype=torch.int64, device=T_curr_ref.device)
    R = se3.rotation(T_curr_ref)
    t = se3.translation(T_curr_ref)
    C = -R.T @ t
    B = torch.linalg.norm(C)
    threshold = 1e-5 * state.scene.avg_depth + 1e-9
    m_x = 0.75 * width
    m_y = 0.75 * height

    def _inside(e):
        return ((torch.abs(cam.fx * e[0]) < m_x * torch.abs(e[2]))
                & (torch.abs(cam.fy * e[1]) < m_y * torch.abs(e[2])))

    zero = B <= threshold
    if cfg.forward_motion_fallback:
        axial = _inside(C) | _inside(t)
        return torch.where(zero, PURE_ROTATION, torch.where(axial, PLANE_SWEEP, RECTIFIED))
    return torch.where(zero, PURE_ROTATION, RECTIFIED)


def _mm(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """float32 matrix product with every sum taken left to right."""
    A, B = np.asarray(A, np.float32), np.asarray(B, np.float32)
    out = A[..., :, 0, None] * B[..., None, 0, :]
    for k in range(1, A.shape[-1]):
        out = out + A[..., :, k, None] * B[..., None, k, :]
    return out


def regime_index(T_curr_world, T_world_ref, avg_depth, fx, fy, height: int, width: int,
                 cfg: RemodeConfig) -> int:
    """``regime_device`` from host copies, in numpy float32 and in the same
    order of operations: ``T_curr_ref = T_curr_world * T_world_ref``, the
    baseline ``C = -R^T t`` and its length ``B``, the zero-baseline threshold
    ``1e-5 avg_depth + 1e-9``, the epipole tests on ``C`` and ``t``.
    ``T_*`` are (3, 4) arrays, ``avg_depth``, ``fx``, ``fy`` the float32
    values the device holds. The choice can differ from the device's only
    where ``B`` or an epipole coordinate lies within a rounding of its
    threshold."""
    if not cfg.zero_baseline_fallback:
        return RECTIFIED
    f32 = np.float32
    A = np.asarray(T_curr_world, f32)
    W = np.asarray(T_world_ref, f32)
    R = _mm(A[:, :3], W[:, :3])
    t = _mm(A[:, :3], W[:, 3:])[:, 0] + A[:, 3]
    C = _mm(-R.T, t[:, None])[:, 0]
    B = np.sqrt(np.sum(C * C, dtype=f32), dtype=f32)
    threshold = f32(1e-5) * f32(avg_depth) + f32(1e-9)
    m_x, m_y = f32(0.75 * width), f32(0.75 * height)
    fx, fy = f32(fx), f32(fy)

    def _inside(e):
        return bool((abs(fx * e[0]) < m_x * abs(e[2])) & (abs(fy * e[1]) < m_y * abs(e[2])))

    if B <= threshold:
        return PURE_ROTATION
    if cfg.forward_motion_fallback and (_inside(C) or _inside(t)):
        return PLANE_SWEEP
    return RECTIFIED


def match(state: SeedState, curr_img, T_curr_ref, cam: PinholeCamera,
          cfg: RemodeConfig, regime: int | None = None,
          planes: bool = False) -> MatchResult | RectPlanes:
    """Rectified sweep with fallbacks for the two motion regimes
    rectification cannot serve: near-zero baseline -> pure-rotation
    matcher; an epipole inside/near either image footprint (axial motion)
    -> inverse-depth plane sweep. ``regime`` (``regime_index``, from host
    copies) picks the branch; without it the device's choice
    (``regime_device``) is read on the host. With ``planes`` the rectified
    branch stops at the back-warp and returns its ``RectPlanes``
    (``unrectify`` finishes them)."""
    rectified = match_rectified_planes if planes else match_rectified
    if not cfg.zero_baseline_fallback:
        return rectified(state, curr_img, T_curr_ref, cam, cfg)
    if regime is None:
        height, width = curr_img.shape
        regime = int(regime_device(state, T_curr_ref, cam, cfg, height, width))
    branch = (match_pure_rotation, epipolar.match_planesweep, rectified)[regime]
    return branch(state, curr_img, T_curr_ref, cam, cfg)
