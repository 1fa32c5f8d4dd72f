"""The rectified matcher on a mesh: gather, match a band, gather
(counterpart of ``rpg_open_remode_tpu/parallel/rect_sharded.py``).

Seed state lives in tiles; the current frame is on every rank. The
rectification warps and the sweep are global, so each rank

  1. gathers the warp inputs over the spatial axis (one ``all_gather`` of
     the stacked fields),
  2. computes one horizontal band of the rect grid, indexed by its spatial
     rank ``ty_idx * n_tx + tx_idx``, on a slab with a 32-row halo on each
     side (clamped at the grid's edges; trimmed after the sweep): the band
     warps (the fused CUDA warp kernel), the band's own coarse-pass gate (no
     collective, so bands may differ; a 0-d bool on the device that the
     coarse sweep reads, so nothing is read on the host) and the sweep (the
     CUDA kernel, on the slab's shape),
  3. gathers the three result maps and back-warps its own reference tile.

The warps take the slab's and the tile's origin as their output window, so
each computes exactly the rows (and columns) of the single-device warp; the
JAX package folds those origins into the homographies, which its
static-origin Pallas resamplers need, and so rounds slightly differently.
Away from the band-local coarse gate, a band is then the single path's
rows bit for bit.

The straggler phase is a ``max`` and the disparity base a ``min`` over the
spatial axis, so every band slices and rebases alike. On CPU tensors the
kernels' plain versions run, as everywhere in the port.
"""

from __future__ import annotations

import torch

from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig
from rpg_open_remode_tpu_torch.ops import rect_match
from rpg_open_remode_tpu_torch.ops.epipolar import MatchResult
from rpg_open_remode_tpu_torch.parallel import collectives
from rpg_open_remode_tpu_torch.parallel.mesh import assemble_tiles
from rpg_open_remode_tpu_torch.utils import warp as warp_ops
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera


def _gather_full(x_tile: torch.Tensor, mesh) -> torch.Tensor:
    """The full ``[..., H, W]`` field from the spatial tiles."""
    return assemble_tiles(collectives.all_gather(mesh, x_tile, "sp"), mesh.shape[2])


def band_slab(rect_h: int, n_bands: int, band: int) -> tuple[int, int, int, int]:
    """``(band_y0, band_h, y0_ext, ext)``: the band's rows and its slab's,
    a 32-row halo each side clamped inside the grid (no halo when the band
    is nearly the whole grid)."""
    if rect_h % n_bands:
        raise ValueError(f"rect height {rect_h} does not split into {n_bands} bands")
    band_h = rect_h // n_bands
    halo = 32 if band_h + 64 <= rect_h else 0
    band_y0 = band * band_h
    ext = band_h + 2 * halo
    y0_ext = min(max(band_y0 - halo, 0), rect_h - ext)
    return band_y0, band_h, y0_ext, ext


def match_rectified_sharded(state_tile, curr_img: torch.Tensor, T_curr_ref: torch.Tensor,
                            cam: PinholeCamera, cfg: RemodeConfig, height: int, width: int,
                            tile_origin, mesh) -> MatchResult:
    """The tile-local MatchResult of this rank's reference tile
    (``state_tile``'s image fields are ``[th, tw]``, at ``tile_origin`` =
    (y0, x0)); ``curr_img`` is the full current frame."""
    th, tw = state_tile.mu.shape
    rect_h, rect_w = rect_match.rect_shape(height, width)
    pad = cfg.disp_pad
    y0_t, x0_t = tile_origin
    band_y0, band_h, y0_ext, ext = band_slab(rect_h, mesh.axis_size("sp"), mesh.axis_index("sp"))
    dev = curr_img.device

    # geometry (identical on every rank)
    g = rect_match.rect_geometry(T_curr_ref, cam, height, width)
    B, s, R_rect = g["B"], g["s"], g["R_rect"]

    # gather the warp inputs, compute this rank's band
    fields = [state_tile.mu, state_tile.sigma_sq, state_tile.ref_img, state_tile.conv.float()]
    if cfg.straggler_slice:
        strag_t, fruitless_t = rect_match.straggler_flag(state_tile.a, state_tile.b, cfg)
        fields.append(strag_t)
    full = _gather_full(torch.stack(fields), mesh)
    mu_f, sig_f, ref_f, conv_f = full[0], full[1], full[2], full[3]
    f_ref_full = cam.bearing_grid(height, width)

    sigma = torch.sqrt(sig_f)
    d_lo = torch.clamp(mu_f - cfg.sigma_band * sigma, min=cfg.min_search_depth)
    d_hi = mu_f + cfg.sigma_band * sigma
    d_center = mu_f
    if cfg.straggler_slice:
        # the phase is the image-wide max, so every band slices alike
        n_est = collectives.all_reduce(mesh, torch.max(fruitless_t), "sp", "max")
        d_lo, d_hi, d_center = rect_match.straggler_slice_bands(
            d_lo, d_hi, mu_f, full[4], n_est, torch.abs(s) * B, cfg)
    rz = torch.clamp(torch.einsum("j,jhw->hw", R_rect[2], f_ref_full), min=1e-3)
    z_floor = 1e-4
    # only UPDATE seeds are matched (epipolar_match.cu:51-57)
    active = (conv_f == int(ConvergenceState.UPDATE)).float()
    ref_stack = torch.stack([
        ref_f,
        torch.clamp(d_lo * rz, min=z_floor),
        torch.clamp(d_center * rz, min=z_floor),
        torch.clamp(d_hi * rz, min=z_floor),
        active,
    ])

    def band_warp(img_stack, H, w_out, x0=0.0, want_uv=True):
        # the slab as the warp's output window: exactly the single path's
        # rows (the JAX package folds the origin into H, for its
        # static-origin Pallas path, and so rounds differently)
        return warp_ops.homography_warp(img_stack, H, ext, w_out, x0=x0, y0=float(y0_ext),
                                        want_uv=want_uv)

    ref_r, u_s, v_s = band_warp(ref_stack, g["H_rect_to_ref"], rect_w)
    # ref-footprint validity is analytic: the resampler clamp-extends
    valid_r = (
        (u_s >= 0.0) & (u_s <= width - 1.0) & (v_s >= 0.0) & (v_s <= height - 1.0)
    ).float()
    xlim_full = rect_match._footprint_xlim(
        g["H_curr_to_rect"], height, width, rect_h,
        reach=cfg.patch_side // 2 + 1.5, vrows=cfg.patch_side,
    )
    xlim_ext = xlim_full[y0_ext:y0_ext + ext]

    fxB = torch.abs(s) * B
    disp_lo = fxB / ref_r[3]
    disp_hi = fxB / ref_r[1]
    disp_mu = fxB / ref_r[2]
    half_len = 0.5 * torch.clamp(disp_hi - disp_lo, max=cfg.max_epipolar_extent)
    disp_lo = torch.maximum(disp_lo, disp_mu - half_len)
    disp_hi = torch.minimum(disp_hi, disp_mu + half_len)
    act = ref_r[4] > 1e-3
    inf = torch.full_like(disp_lo, float("inf"))
    disp_lo = torch.where(act, disp_lo, inf)
    disp_hi = torch.where(act, disp_hi, -inf)

    # constant disparity rebasing on the global base (a min over the bands)
    if cfg.disp_rebase:
        lo_valid = torch.where(valid_r > 0.999, disp_lo, inf)
        gmin = collectives.all_reduce(mesh, torch.min(lo_valid), "sp", "min")
        base_raw = torch.floor(gmin) - 1.0
        kbase = torch.where(torch.isfinite(base_raw), torch.clamp(base_raw, min=0.0),
                            torch.zeros_like(base_raw))
    else:
        kbase = torch.zeros((), dtype=torch.float32, device=dev)
    disp_lo = disp_lo - kbase
    disp_hi = disp_hi - kbase
    xlim_ext = xlim_ext + kbase
    z = torch.zeros((), dtype=torch.float32, device=dev)
    o = torch.ones((), dtype=torch.float32, device=dev)
    M_aff = torch.stack([torch.stack([o, z, -kbase]), torch.stack([z, o, z]),
                         torch.stack([z, z, o])])
    curr_r, _, _ = band_warp(curr_img, g["H_rect_to_curr"] @ M_aff, rect_w + 2 * pad,
                             x0=-float(pad), want_uv=False)
    ref_img_r = ref_r[0].contiguous()

    if cfg.coarse_to_fine:
        # the band's own gate (band-local, no collective), a 0-d bool that
        # stays on the device: the coarse sweep returns at once when it is
        # off, and the bands are kept as they were (the JAX lax.cond)
        extent = disp_hi - disp_lo
        wide_n = torch.isfinite(extent) & (extent > 2.0 * cfg.coarse_refine_radius + 2.0)
        gate = wide_n.float().mean() > 0.15
        coarse_args = rect_match.coarse_sweep_args(
            curr_r, ref_img_r, valid_r, xlim_ext, disp_lo, disp_hi, cfg)
        disp_lo, disp_hi = rect_match._coarse_narrow(coarse_args, disp_lo, disp_hi, cfg, gate)

    disp_b, ncc_b, found_b = rect_match.disparity_sweep(
        curr_r.contiguous(), xlim_ext.contiguous(), ref_img_r, valid_r.contiguous(),
        disp_lo.contiguous(), disp_hi.contiguous(), cfg.ncc_threshold, cfg.num_planes,
        pad, cfg.patch_side, cfg.subplane_refine,
    )
    # trim the halo: this rank's band rows; found-masked as the single path
    off = band_y0 - y0_ext
    found_fl = found_b.float()
    band_out = torch.stack([
        (disp_b + kbase) * found_fl, ncc_b * found_fl, found_fl,
    ])[:, off:off + band_h]

    # gather the sweep results, back-warp this rank's reference tile
    full_out = torch.cat(collectives.all_gather(mesh, band_out, "sp"), dim=1)
    back, _, _ = warp_ops.homography_warp(full_out, g["H_ref_to_rect"], th, tw,
                                          x0=float(x0_t), y0=float(y0_t), want_uv=False)
    found_t = back[2]
    wgt = torch.clamp(found_t, min=1e-6)
    disp_t = back[0] / wgt
    ncc_t = back[1] / wgt

    yy = y0_t + torch.arange(th, dtype=torch.float32, device=dev)[:, None]
    xx = x0_t + torch.arange(tw, dtype=torch.float32, device=dev)[None, :]
    xr, yr = warp_ops.homography_coords(g["H_ref_to_rect"], xx, yy)
    Hc = g["H_rect_to_curr"]
    uc_r = xr - disp_t
    den_c = Hc[2, 0] * uc_r + Hc[2, 1] * yr + Hc[2, 2]
    den_c = torch.where(torch.abs(den_c) < 1e-8, torch.full_like(den_c, 1e-8), den_c)
    u_c = (Hc[0, 0] * uc_r + Hc[0, 1] * yr + Hc[0, 2]) / den_c
    v_c = (Hc[1, 0] * uc_r + Hc[1, 1] * yr + Hc[1, 2]) / den_c

    found = (found_t > 0.5) & (ncc_t >= cfg.ncc_threshold)
    return MatchResult(found=found, u=u_c, v=v_c, best_ncc=torch.clamp(ncc_t, -1.0, 1.0))
