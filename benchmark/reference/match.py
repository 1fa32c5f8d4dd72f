"""Frozen copies of rpg_open_remode_tpu_torch/ops/rect_match.py, the plain
version of ops/sweep_cuda.py and the plane sweep of ops/epipolar.py: the
rectified disparity-sweep NCC matcher with its pure-rotation and plane-sweep
fallbacks, and the host's choice among them."""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

# the originals' module names, so the copied code reads as its source
from benchmark.reference import geometry as se3
from benchmark.reference import geometry as warp_ops
from benchmark.reference.config import UPDATE, Config
from benchmark.reference.geometry import bilinear, box_zero, window_sum

_FLT_MIN = 1.1754944e-38
_NEG = -1e30


class MatchResult(NamedTuple):
    found: torch.Tensor     # bool [H, W]: best NCC >= threshold
    u: torch.Tensor         # float [H, W] matched x coord in curr frame
    v: torch.Tensor         # float [H, W] matched y coord in curr frame
    best_ncc: torch.Tensor  # float [H, W]


def _project_depth(Rf, t, d, cam):
    """Project the point at along-ray depth ``d`` on bearing field ``Rf``
    (rotated into the current frame). Returns (u, v, z)."""
    px = Rf[0] * d + t[0]
    py = Rf[1] * d + t[1]
    pz = Rf[2] * d + t[2]
    return cam.fx * px / pz + cam.cx, cam.fy * py / pz + cam.cy, pz


def plane_set(scene, cfg: Config):
    """Shared inverse-depth planes d_k = 1/(inv_lo + k*step) over the scene
    range widened 1.3x."""
    d_min = torch.clamp(scene.min_depth / 1.3, min=cfg.min_search_depth)
    d_max = scene.max_depth * 1.3
    inv_hi = 1.0 / d_min
    inv_lo = 1.0 / d_max
    inv_step = (inv_hi - inv_lo) / (cfg.num_planes - 1)
    return inv_lo, inv_step


def match_planesweep_tile(ref_ext, f_ext, mu, sigma_sq, sum_templ, const_templ_denom,
                          scene, curr_img, T_curr_ref, cam,
                          cfg: Config) -> MatchResult:
    """Plane sweep over one tile of the seed state: ``ref_ext``/``f_ext``
    carry a p-px halo (p = patch_side // 2), so box sums are 'valid' sums."""
    height, width = curr_img.shape
    area = float(cfg.patch_area)
    p = cfg.patch_side // 2
    side = cfg.patch_side

    R = se3.rotation(T_curr_ref)
    t = se3.translation(T_curr_ref)
    Rf_ext = torch.einsum("ij,jhw->ihw", R, f_ext)
    Rf = Rf_ext[:, p:-p, p:-p]
    inv_lo, inv_step = plane_set(scene, cfg)

    sigma = torch.sqrt(sigma_sq)
    d_lo = torch.clamp(mu - cfg.sigma_band * sigma, min=cfg.min_search_depth)
    d_hi = mu + cfg.sigma_band * sigma
    u_mu, v_mu, _ = _project_depth(Rf, t, mu, cam)
    u_a, v_a, _ = _project_depth(Rf, t, d_lo, cam)
    u_b, v_b, _ = _project_depth(Rf, t, d_hi, cam)
    seg_len = torch.sqrt((u_b - u_a) ** 2 + (v_b - v_a) ** 2)
    half_length = 0.5 * torch.clamp(seg_len, max=cfg.max_epipolar_extent)
    m = float(cfg.patch_side)
    neg = torch.full_like(mu, _NEG)

    def valid_box(x):
        return window_sum(window_sum(x, side, 1), side, 0)

    best = torch.full_like(mu, -1.0)
    best_k = torch.full(mu.shape, -10, dtype=torch.int32, device=mu.device)
    left, right, prev = neg, neg, neg
    for k in range(cfg.num_planes):
        d = 1.0 / (inv_lo + inv_step * k)
        ue, ve, _ = _project_depth(Rf_ext, t, d, cam)
        warped = bilinear(curr_img, ue, ve)
        s_i = valid_box(warped)
        s_ii = valid_box(warped * warped)
        s_it = valid_box(warped * ref_ext)
        num = area * s_it - s_i * sum_templ
        den = (area * s_ii - s_i * s_i) * const_templ_denom
        ncc = num * torch.rsqrt(den + _FLT_MIN)
        u = ue[p:-p, p:-p]
        v = ve[p:-p, p:-p]
        z = Rf[2] * d + t[2]
        visible = (u >= m) & (u < width - m) & (v >= m) & (v < height - m) & (z > 0)
        in_band = (d >= d_lo) & (d <= d_hi)
        dist = torch.sqrt((u - u_mu) ** 2 + (v - v_mu) ** 2)
        ncc = torch.where(visible & in_band & (dist <= half_length), ncc, neg)
        improved = ncc > best
        right = torch.where(best_k == k - 1, ncc, right)
        left = torch.where(improved, prev, left)
        right = torch.where(improved, neg, right)
        best_k = torch.where(improved, k, best_k)
        best = torch.where(improved, ncc, best)
        prev = ncc

    # sub-plane parabolic refinement in inverse depth
    kf = best_k.float()
    if cfg.subplane_refine:
        have = (left > _NEG * 0.5) & (right > _NEG * 0.5)
        denom = left - 2.0 * best + right
        delta = torch.where(
            have & (torch.abs(denom) > 1e-12), 0.5 * (left - right) / denom,
            torch.zeros_like(denom),
        )
        kf = kf + torch.clamp(delta, -0.5, 0.5)
    d_best = 1.0 / (inv_lo + inv_step * kf)
    u_best, v_best, _ = _project_depth(Rf, t, d_best, cam)
    found = (best >= cfg.ncc_threshold) & (best_k >= 0)
    return MatchResult(found=found, u=u_best, v=v_best, best_ncc=best)


def extend_with_clamp(img: torch.Tensor, p: int) -> torch.Tensor:
    """Edge-replicate halo == CUDA clamp-addressed texture semantics."""
    return torch.nn.functional.pad(img[None, None], (p, p, p, p), mode="replicate")[0, 0]


def bearings_for_grid(cam, ys: torch.Tensor, xs: torch.Tensor):
    """Normalized bearings for pixel coordinate vectors, [3, len(ys), len(xs)]."""
    v, u = torch.meshgrid(ys.float(), xs.float(), indexing="ij")
    f = cam.cam2world(u, v)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)
    return torch.movedim(f, -1, 0)


def match_planesweep(state, curr_img, T_curr_ref, cam,
                     cfg: Config) -> MatchResult:
    """The tile sweep on the whole image with a clamped halo."""
    height, width = curr_img.shape
    p = cfg.patch_side // 2
    dev = curr_img.device
    ys = torch.clamp(torch.arange(-p, height + p, device=dev), 0, height - 1)
    xs = torch.clamp(torch.arange(-p, width + p, device=dev), 0, width - 1)
    return match_planesweep_tile(
        extend_with_clamp(state.ref_img, p), bearings_for_grid(cam, ys, xs),
        state.mu, state.sigma_sq, state.sum_templ, state.const_templ_denom,
        state.scene, curr_img, T_curr_ref, cam, cfg,
    )


def _not_found(ref_img):
    shape, dev = ref_img.shape, ref_img.device
    return (torch.full(shape, -10.0, device=dev), torch.full(shape, -1.0, device=dev),
            torch.zeros(shape, dtype=torch.bool, device=dev))


def disparity_sweep_plain(
    curr_pad, xlim, ref_img, valid, disp_lo, disp_hi,
    ncc_threshold: float, num_planes: int, pad: int, patch_side: int,
    subplane_refine: bool, gate=None,
):
    """The sweep with one whole-image tensor op per step (port of
    rect_match._sweep_xla). A gate that is off gives the not-found result
    (on the CPU the gate is read; elsewhere the result is selected)."""
    if gate is not None and not gate.is_cuda and not bool(gate):
        return _not_found(ref_img)
    out = _sweep_plain(curr_pad, xlim, ref_img, valid, disp_lo, disp_hi, ncc_threshold,
                       num_planes, pad, patch_side, subplane_refine)
    if gate is None or not gate.is_cuda:
        return out
    return tuple(torch.where(gate, a, b) for a, b in zip(out, _not_found(ref_img)))


def _sweep_plain(curr_pad, xlim, ref_img, valid, disp_lo, disp_hi, ncc_threshold,
                 num_planes, pad, patch_side, subplane_refine):
    rect_h, rect_w = ref_img.shape
    side = patch_side
    area = float(side * side)
    assert num_planes <= pad - 1, (num_planes, pad)

    sum_t = box_zero(ref_img, side)
    denom_t = area * box_zero(ref_img * ref_img, side) - sum_t * sum_t
    ref_ok = box_zero((valid > 0.999).float(), side) > (area - 0.5)
    ref_ok &= denom_t > 1e-10
    lo = disp_lo - 0.5
    hi = disp_hi + 0.5
    xcoord = torch.arange(rect_w, dtype=torch.float32, device=ref_img.device)[None, :]
    xmin_e = xlim[:, 0:1]
    xmax_e = xlim[:, 1:2]

    best = torch.full_like(ref_img, -1.0)
    best_k = torch.full(ref_img.shape, -10, dtype=torch.int32, device=ref_img.device)
    left = torch.full_like(ref_img, _NEG)
    right = torch.full_like(ref_img, _NEG)
    prev = torch.full_like(ref_img, _NEG)
    neg = torch.full_like(ref_img, _NEG)
    for k in range(num_planes):
        delta = float(k)
        img = curr_pad[:, pad - k: pad - k + rect_w]
        s_i = box_zero(img, side)
        s_ii = box_zero(img * img, side)
        s_it = box_zero(img * ref_img, side)
        num = area * s_it - s_i * sum_t
        den_l = area * s_ii - s_i * s_i
        ncc = num * torch.rsqrt(torch.clamp(den_l * denom_t, min=_FLT_MIN))
        x_src = xcoord - delta
        ok = (
            ref_ok
            & (den_l > 1e-10)
            & (x_src >= xmin_e)
            & (x_src <= xmax_e)
            & (delta >= lo)
            & (delta <= hi)
        )
        ncc = torch.where(ok, ncc, neg)
        improved = ncc > best
        right = torch.where(best_k == k - 1, ncc, right)
        left = torch.where(improved, prev, left)
        right = torch.where(improved, neg, right)
        best_k = torch.where(improved, k, best_k)
        best = torch.where(improved, ncc, best)
        prev = ncc

    kf = best_k.float()
    if subplane_refine:
        have = (left > 0.5 * _NEG) & (right > 0.5 * _NEG)
        den = left - 2.0 * best + right
        frac = torch.where(
            have & (torch.abs(den) > 1e-12), 0.5 * (left - right) / den,
            torch.zeros_like(den),
        )
        kf = kf + torch.clamp(frac, -0.5, 0.5)
    found = (best >= ncc_threshold) & (best_k >= 0)
    return kf, best, found


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
                      cfg: Config) -> tuple:
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


def _coarse_narrow(coarse_args, disp_lo, disp_hi, cfg: Config, gate=None):
    """Coarse-to-fine: localize each pixel's NCC peak on the half-resolution
    grid (``coarse_sweep_args``), then shrink its band to
    +-coarse_refine_radius planes around the peak. Pixels the coarse pass
    cannot place keep their full band. ``gate`` (a 0-d bool on the device;
    None: on) is the JAX package's ``lax.cond``: the sweep skips its work
    when it is off, and every band is then kept as it was."""
    d_c, _, found_c = disparity_sweep_plain(*coarse_args, gate=gate)
    d_up = torch.repeat_interleave(2.0 * d_c, 2, dim=1)
    f_up = torch.repeat_interleave(found_c, 2, dim=1)
    r = cfg.coarse_refine_radius
    lo2 = torch.maximum(disp_lo, d_up - r)
    hi2 = torch.minimum(disp_hi, d_up + r)
    ok = f_up & (lo2 <= hi2)
    if gate is not None:
        ok = ok & gate   # torch.where(gate, narrowed, unnarrowed)
    return torch.where(ok, lo2, disp_lo), torch.where(ok, hi2, disp_hi)


def straggler_flag(a: torch.Tensor, b: torch.Tensor, cfg: Config):
    """Per-seed straggler predicate and fruitless-frame count: at least
    ``straggler_after`` net outlier pseudo-counts while the inlier-ratio
    mean is below 0.45."""
    fruitless = b - cfg.b_init
    flag = (fruitless >= cfg.straggler_after) & (a / (a + b) < 0.45)
    return flag.float(), fruitless


def straggler_slice_bands(d_lo, d_hi, mu, strag, n_est, fxB, cfg: Config):
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


def rect_geometry(T_curr_ref, cam, height: int, width: int) -> dict:
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


def prepare_sweep(state, curr_img, T_curr_ref, cam,
                  cfg: Config) -> dict:
    """Everything ``match_rectified`` does before the full sweep:
    rectification warps, footprint interval, per-pixel disparity bands
    (Bayesian band intersected with the extent cap), disparity rebasing and
    the coarse-to-fine narrowing. Returns the sweep inputs, under
    ``coarse_args`` the coarse pass's arguments and under ``gate`` its 0-d
    bool gate on the device (both None without ``cfg.coarse_to_fine``)."""
    height, width = curr_img.shape
    dev = curr_img.device
    pad = cfg.disp_pad
    g = rect_geometry(T_curr_ref, cam, height, width)
    rect_h, rect_w = g["rect_h"], g["rect_w"]
    B, s, R_rect = g["B"], g["s"], g["R_rect"]

    sigma = torch.sqrt(state.sigma_sq)
    d_lo = torch.clamp(state.mu - cfg.sigma_band * sigma, min=cfg.min_search_depth)
    d_hi = state.mu + cfg.sigma_band * sigma
    d_center = state.mu
    if cfg.straggler_slice:
        strag, fruitless = straggler_flag(state.a, state.b, cfg)
        d_lo, d_hi, d_center = straggler_slice_bands(
            d_lo, d_hi, state.mu, strag, torch.max(fruitless), torch.abs(s) * B, cfg,
        )
    rz = torch.einsum("j,jhw->hw", R_rect[2], state.f_ref)
    rz = torch.clamp(rz, min=1e-3)
    z_floor = 1e-4
    # only UPDATE seeds are matched (epipolar_match.cu:51-57)
    active = (state.conv == UPDATE).float()
    ref_stack = torch.stack([
        state.ref_img,
        torch.clamp(d_lo * rz, min=z_floor),
        torch.clamp(d_center * rz, min=z_floor),
        torch.clamp(d_hi * rz, min=z_floor),
        active,
    ])
    ref_r, u_s, v_s = warp_ops.homography_warp(ref_stack, g["H_rect_to_ref"], rect_h, rect_w)
    ref_img_r, z_lo_r, z_mu_r, z_hi_r, act_r = ref_r.unbind(0)
    # ref-footprint validity is analytic: the resampler clamp-extends
    valid_r = (
        (u_s >= 0.0) & (u_s <= width - 1.0) & (v_s >= 0.0) & (v_s <= height - 1.0)
    ).float()

    xlim = _footprint_xlim(
        g["H_curr_to_rect"], height, width, rect_h,
        reach=cfg.patch_side // 2 + 1.5, vrows=cfg.patch_side,
    )

    # per-pixel disparity bands: disparity = |s| B / z
    fxB = torch.abs(s) * B
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
    if cfg.disp_rebase:
        lo_valid = torch.where(valid_r > 0.999, disp_lo, inf)
        base_raw = torch.floor(torch.min(lo_valid)) - 1.0
        kbase = torch.where(
            torch.isfinite(base_raw), torch.clamp(base_raw, min=0.0),
            torch.zeros_like(base_raw),
        )
    else:
        kbase = torch.zeros((), dtype=torch.float32, device=dev)
    k_lo = disp_lo - kbase
    k_hi = disp_hi - kbase
    xlim = xlim + kbase

    z = torch.zeros((), dtype=torch.float32, device=dev)
    o = torch.ones((), dtype=torch.float32, device=dev)
    M_aff = torch.stack([torch.stack([o, z, -kbase]), torch.stack([z, o, z]),
                         torch.stack([z, z, o])])
    # the pad stays an exact integer output-origin shift, outside the product
    curr_img_r, _, _ = warp_ops.homography_warp(
        curr_img, g["H_rect_to_curr"] @ M_aff, rect_h, rect_w + 2 * pad, x0=-float(pad),
        want_uv=False,
    )
    disp_lo, disp_hi = k_lo, k_hi

    coarse_args = gate = None
    if cfg.coarse_to_fine:
        # pay the coarse pass only while wide bands cover a meaningful
        # fraction of the image (young keyframes): the gate stays on the
        # device, the arguments are always built, and the kernel skips its
        # work when the gate is off
        extent = disp_hi - disp_lo
        wide_n = torch.isfinite(extent) & (extent > 2.0 * cfg.coarse_refine_radius + 2.0)
        gate = wide_n.float().mean() > 0.15
        coarse_args = coarse_sweep_args(
            curr_img_r, ref_img_r, valid_r, xlim, disp_lo, disp_hi, cfg,
        )
        disp_lo, disp_hi = _coarse_narrow(coarse_args, disp_lo, disp_hi, cfg, gate)

    return dict(
        g=g, curr_img_r=curr_img_r.contiguous(), ref_img_r=ref_img_r.contiguous(),
        valid_r=valid_r.contiguous(), xlim=xlim.contiguous(),
        disp_lo=disp_lo.contiguous(), disp_hi=disp_hi.contiguous(), kbase=kbase,
        coarse_args=coarse_args, gate=gate,
    )


def match_rectified(state, curr_img, T_curr_ref, cam, cfg: Config,
                    observe=None) -> MatchResult:
    """``observe(p)``, when given, receives ``prepare_sweep``'s result: the
    sweep's inputs, for the benchmark's accounting."""
    height, width = curr_img.shape
    p = prepare_sweep(state, curr_img, T_curr_ref, cam, cfg)
    if observe is not None:
        observe(p)
    g = p["g"]
    disp_best, best, found_r = disparity_sweep_plain(
        p["curr_img_r"], p["xlim"], p["ref_img_r"], p["valid_r"],
        p["disp_lo"], p["disp_hi"], cfg.ncc_threshold, cfg.num_planes,
        cfg.disp_pad, cfg.patch_side, cfg.subplane_refine,
    )

    # back-warp to the reference grid, found-masked and renormalized so
    # the -10 not-found sentinel never mixes into a match
    disp_best = disp_best + p["kbase"]
    H_ref_to_rect = g["H_ref_to_rect"]
    H_rect_to_curr = g["H_rect_to_curr"]
    found_f = found_r.float()
    out_stack = torch.stack([disp_best * found_f, best * found_f, found_f])
    back, _, _ = warp_ops.homography_warp(out_stack, H_ref_to_rect, height, width,
                                          want_uv=False)
    found_b = back[2]
    wgt = torch.clamp(found_b, min=1e-6)
    disp_b = back[0] / wgt
    ncc_b = back[1] / wgt

    dev = curr_img.device
    yy = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    xr, yr = warp_ops.homography_coords(H_ref_to_rect, xx, yy)

    # match position in the current image: unrectify (x_r - disp, y_r)
    Hc = H_rect_to_curr
    uc_r = xr - disp_b
    den_c = Hc[2, 0] * uc_r + Hc[2, 1] * yr + Hc[2, 2]
    den_c = torch.where(torch.abs(den_c) < 1e-8, torch.full_like(den_c, 1e-8), den_c)
    u_c = (Hc[0, 0] * uc_r + Hc[0, 1] * yr + Hc[0, 2]) / den_c
    v_c = (Hc[1, 0] * uc_r + Hc[1, 1] * yr + Hc[1, 2]) / den_c

    found = (found_b > 0.5) & (ncc_b >= cfg.ncc_threshold)
    return MatchResult(found=found, u=u_c, v=v_c, best_ncc=torch.clamp(ncc_b, -1.0, 1.0))


def match_pure_rotation(state, curr_img, T_curr_ref, cam,
                        cfg: Config) -> MatchResult:
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


# matcher branches, by regime index
PURE_ROTATION, PLANE_SWEEP, RECTIFIED = 0, 1, 2


def _mm(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """float32 matrix product with every sum taken left to right."""
    A, B = np.asarray(A, np.float32), np.asarray(B, np.float32)
    out = A[..., :, 0, None] * B[..., None, 0, :]
    for k in range(1, A.shape[-1]):
        out = out + A[..., :, k, None] * B[..., None, k, :]
    return out


def regime_index(T_curr_world, T_world_ref, avg_depth, fx, fy, height: int, width: int,
                 cfg: Config) -> int:
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


def match(state, curr_img, T_curr_ref, cam, cfg: Config, regime: int,
          observe=None) -> MatchResult:
    """The matcher branch ``regime`` (``regime_index``): pure rotation,
    plane sweep or rectified sweep (which hands its sweep inputs to
    ``observe``)."""
    if not cfg.zero_baseline_fallback or regime == RECTIFIED:
        return match_rectified(state, curr_img, T_curr_ref, cam, cfg, observe)
    branch = (match_pure_rotation, match_planesweep)[regime]
    return branch(state, curr_img, T_curr_ref, cam, cfg)
