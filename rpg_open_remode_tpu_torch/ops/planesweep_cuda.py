"""The plane-sweep matcher of one tile as one CUDA kernel
(``csrc/planesweep.cu``) and its plain PyTorch version.

The plain version is the loop ``epipolar.match_planesweep_tile`` ran
before the kernel, moved here unchanged: for each of ``cfg.num_planes``
inverse-depth planes the bilinear warp of the current image, three
'valid' box sums, the ZNCC, the visibility, band and segment masks and the
running best, then the sub-plane parabolic refinement. It replaces no TPU
kernel: XLA fused this loop in the JAX package; on the card the plain loop
is ~103 whole-image kernel launches a plane, ~13,000 a frame at 127
planes.

``epipolar.match_planesweep_tile`` dispatches here. On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel or
raises. ``Rf_ext`` (the window's bearings rotated into the current frame)
and the plane set stay PyTorch operations before the launch. The kernel
reads every input on the device, so a CUDA graph captures it.

Beside ``kernels.LAUNCHES["planesweep"]`` the kernel counts on the device
the (tile, plane) pairs it skipped, those where no pixel of a tile
(``TILE``) scores the plane, and all pairs (``plane_counts``).
"""

from __future__ import annotations

import ctypes

import torch

from rpg_open_remode_tpu_torch import kernels
from rpg_open_remode_tpu_torch.config import RemodeConfig
from rpg_open_remode_tpu_torch.ops import epipolar
from rpg_open_remode_tpu_torch.ops.epipolar import _FLT_MIN, _NEG, MatchResult, _project_depth
from rpg_open_remode_tpu_torch.utils import se3
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera
from rpg_open_remode_tpu_torch.utils.interp import bilinear, window_sum

# the patch sides the kernel is built for (its template's radii 2 .. 8)
SIDES = (5, 7, 9, 11, 13, 15, 17)
# a block's tile of reference pixels, (rows, columns): kTY, kTX
TILE = (8, 32)


def planesweep_match_plain(ref_ext, f_ext, mu, sigma_sq, sum_templ, const_templ_denom,
                           scene, curr_img, T_curr_ref, cam: PinholeCamera,
                           cfg: RemodeConfig) -> MatchResult:
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
    inv_lo, inv_step = epipolar.plane_set(scene, cfg)

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


def planesweep_match(ref_ext, f_ext, mu, sigma_sq, sum_templ, const_templ_denom, scene,
                     curr_img, T_curr_ref, cam: PinholeCamera, cfg: RemodeConfig) -> MatchResult:
    """The kernel on CUDA tensors, the plain version on CPU tensors; the
    arguments and the result are ``planesweep_match_plain``'s."""
    if not mu.is_cuda:
        return planesweep_match_plain(ref_ext, f_ext, mu, sigma_sq, sum_templ,
                                      const_templ_denom, scene, curr_img, T_curr_ref, cam, cfg)
    return _launch(ref_ext, f_ext, mu, sigma_sq, sum_templ, const_templ_denom, scene, curr_img,
                   T_curr_ref, cam, cfg)


def _launch(ref_ext, f_ext, mu, sigma_sq, sum_templ, const_templ_denom, scene, curr_img,
            T_curr_ref, cam: PinholeCamera, cfg: RemodeConfig) -> MatchResult:
    side = cfg.patch_side
    if side not in SIDES:
        raise ValueError(f"patch_side {side}: the plane-sweep kernel takes {SIDES}")
    p = side // 2
    th, tw = mu.shape
    ext = (th + 2 * p, tw + 2 * p)
    tile = (th, tw)
    for name, x in (("mu", mu), ("sigma_sq", sigma_sq), ("sum_templ", sum_templ),
                    ("const_templ_denom", const_templ_denom)):
        kernels.require(x, name, tile)
    kernels.require(ref_ext, "ref_ext", ext)
    if tuple(f_ext.shape) != (3, *ext):
        raise ValueError(f"f_ext: expected shape {(3, *ext)}, got {tuple(f_ext.shape)}")
    kernels.require(curr_img, "curr_img")
    if curr_img.dim() != 2:
        raise ValueError(f"curr_img: expected [H, W], got {tuple(curr_img.shape)}")
    kernels.require(T_curr_ref, "T_curr_ref", (3, 4))
    for name in ("fx", "fy", "cx", "cy"):
        kernels.require(getattr(cam, name), name, ())
    height, width = curr_img.shape

    Rf_ext = torch.einsum("ij,jhw->ihw", se3.rotation(T_curr_ref), f_ext).contiguous()
    inv_lo, inv_step = epipolar.plane_set(scene, cfg)
    kernels.require(inv_lo, "inv_lo", ())
    kernels.require(inv_step, "inv_step", ())
    dev = mu.device
    found = torch.empty(tile, dtype=torch.bool, device=dev)
    u, v, best_ncc = (torch.empty(tile, dtype=torch.float32, device=dev) for _ in range(3))
    m = float(side)
    # the Python scalars of the plain version, rounded to float32 as PyTorch
    # rounds a scalar operand of a float32 tensor
    err = kernels.library().remode_planesweep(
        ref_ext.data_ptr(), Rf_ext.data_ptr(), mu.data_ptr(), sigma_sq.data_ptr(),
        sum_templ.data_ptr(), const_templ_denom.data_ptr(), curr_img.data_ptr(),
        T_curr_ref.data_ptr(), cam.fx.data_ptr(), cam.fy.data_ptr(), cam.cx.data_ptr(),
        cam.cy.data_ptr(), inv_lo.data_ptr(), inv_step.data_ptr(),
        found.data_ptr(), u.data_ptr(), v.data_ptr(), best_ncc.data_ptr(),
        th, tw, height, width, cfg.num_planes, side, float(cfg.patch_area), m, width - m,
        height - m, cfg.sigma_band, cfg.min_search_depth, cfg.max_epipolar_extent,
        cfg.ncc_threshold, int(bool(cfg.subplane_refine)), kernels.stream_of(mu),
    )
    kernels.check(err, "planesweep")
    kernels.count("planesweep")
    return MatchResult(found=found, u=u, v=v, best_ncc=best_ncc)


def plane_counts(reset: bool = False) -> dict:
    """The (tile, plane) pairs the kernel skipped and swept in all on the
    current device since the last reset, after a device synchronize:
    ``{"skipped": n, "pairs": n}``. With ``reset`` the counts restart at
    0."""
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * 2)()
    kernels.check(kernels.library().remode_planesweep_plane_counts(
        ctypes.addressof(out), int(reset)), "planesweep plane counts")
    return {"skipped": int(out[0]), "pairs": int(out[1])}
