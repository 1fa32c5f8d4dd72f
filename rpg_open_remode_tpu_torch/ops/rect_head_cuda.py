"""The head of a rectified frame step as hand-written CUDA kernels
(``csrc/rect_head.cu``): everything the step does before, between and
around the warps and sweeps, up to the back-warp.

Seven launchers, each one kernel launch (``ref_bands`` two) and the card's
route of one piece of the step whose plain version is in the plain module:

  * ``classify``: ``seed_check.classify`` (every regime);
  * ``geometry``: ``rect_match.geometry``, ``rect_geometry`` and
    ``_footprint_xlim`` into one small buffer (``GEO``), one block;
  * ``ref_bands``: ``rect_match.ref_bands``, the Bayesian band,
    ``straggler_slice_bands`` (its image-wide fruitless maximum a launch of
    its own) and the depth-to-z factor into the reference warp's 5 planes;
  * ``rect_bands``: ``rect_match.rect_bands``, the rect grid's validity and
    disparity bands, then ``kbase`` and ``H_rect_to_curr @ M_aff`` (in
    ``GEO``);
  * ``rect_rebase``: ``rect_match.rebase``, the bands less ``kbase``,
    ``xlim + kbase``, the coarse gate and ``coarse_sweep_args``'
    half-resolution inputs;
  * ``coarse_narrow``: ``rect_match.narrow_bands`` after the coarse sweep;
  * ``back_stack``: ``rect_match.back_stack``.

The plain module's pieces dispatch here on CUDA tensors, and
``rect_match.prepare_sweep`` and ``match_rectified_planes`` chain them with
the warps (``utils/warp``) and sweeps (``ops/sweep_cuda``). Each launcher
takes CUDA tensors or raises. The kernels read every input on the device,
reduce image-wide through accumulators that ``geometry`` resets, and write
``kbase``, the shifted homography and the gate on the device, so a CUDA
graph captures the step.
"""

from __future__ import annotations

import torch

from rpg_open_remode_tpu_torch import kernels
from rpg_open_remode_tpu_torch.config import RemodeConfig
from rpg_open_remode_tpu_torch.models.state import SeedState
from rpg_open_remode_tpu_torch.utils import se3
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera

# the geometry buffer: offsets of its 3x3 matrices (row-major) and scalars,
# as csrc/rect_head.cu lays it out
GEO = dict(H_rect_to_ref=0, H_rect_to_curr=9, H_curr_to_rect=18, H_ref_to_rect=27,
           R_rect=36, H_shift=45, C=54, B=57, s=58, fxB=59, kbase=60)
GEO_LEN = 64
ACC_LEN = 8             # the kernels' image-wide accumulators (int32)
_MATRICES = ("H_rect_to_ref", "H_rect_to_curr", "H_curr_to_rect", "H_ref_to_rect", "R_rect")
_MAX_RECT_H = 6144      # the footprint rows in rect_geometry's shared memory (48 KB)


def _mat(geo: torch.Tensor, name: str) -> torch.Tensor:
    return geo[GEO[name]:GEO[name] + 9].view(3, 3)


def _grid(*shape_and_device) -> torch.Tensor:
    """An uninitialised float32 tensor: ``_grid(*shape, device)``."""
    *shape, device = shape_and_device
    return torch.empty(tuple(shape), dtype=torch.float32, device=device)


def classify(mu, sigma_sq, a, b, epsilon, cfg: RemodeConfig) -> torch.Tensor:
    """Each seed's state in {BORDER, CONVERGED, DIVERGED, UPDATE}, int32
    [H, W]."""
    h, w = mu.shape
    for name, t in (("sigma_sq", sigma_sq), ("a", a), ("b", b)):
        kernels.require(t, name, (h, w))
    kernels.require(epsilon, "epsilon", ())
    conv = torch.empty((h, w), dtype=torch.int32, device=mu.device)
    err = kernels.library().remode_classify(
        sigma_sq.data_ptr(), a.data_ptr(), b.data_ptr(), epsilon.data_ptr(), conv.data_ptr(),
        h, w, cfg.patch_side, cfg.eta_inlier, cfg.eta_outlier, kernels.stream_of(mu))
    kernels.check(err, "classify")
    kernels.count("classify")
    return conv


def geometry(T_curr_ref, cam: PinholeCamera, height: int, width: int, rect_h: int,
             rect_w: int, cfg: RemodeConfig):
    """``(g, xlim_raw)``: ``g`` is ``rect_match.rect_geometry``'s dict as
    views of the geometry buffer, which it also holds under ``"geo"``, and
    under ``"acc"`` the accumulators the later kernels reduce into (reset
    here)."""
    if rect_h > _MAX_RECT_H:
        raise ValueError(f"rect grid of {rect_h} rows: the geometry kernel takes at most "
                         f"{_MAX_RECT_H}")
    kernels.require(T_curr_ref, "T_curr_ref", (3, 4))
    for name in ("fx", "fy", "cx", "cy"):
        kernels.require(getattr(cam, name), name, ())
    dev = T_curr_ref.device
    geo = torch.empty(GEO_LEN, dtype=torch.float32, device=dev)
    xlim = _grid(rect_h, 2, dev)
    acc = torch.empty(ACC_LEN, dtype=torch.int32, device=dev)
    err = kernels.library().remode_rect_geometry(
        T_curr_ref.data_ptr(), cam.fx.data_ptr(), cam.fy.data_ptr(), cam.cx.data_ptr(),
        cam.cy.data_ptr(), geo.data_ptr(), xlim.data_ptr(), acc.data_ptr(), height, width,
        rect_h, rect_w, cfg.patch_side // 2 + 1.5, cfg.patch_side, kernels.stream_of(T_curr_ref))
    kernels.check(err, "rect_geometry")
    kernels.count("rect_geometry")
    g = {name: _mat(geo, name) for name in _MATRICES}
    g.update(rect_h=rect_h, rect_w=rect_w, R=se3.rotation(T_curr_ref),
             t=se3.translation(T_curr_ref), C=geo[GEO["C"]:GEO["C"] + 3], B=geo[GEO["B"]],
             s=geo[GEO["s"]], geo=geo, acc=acc)
    return g, xlim


def ref_bands(state: SeedState, geo: torch.Tensor, acc: torch.Tensor,
              cfg: RemodeConfig) -> torch.Tensor:
    """The reference warp's input [5, H, W]."""
    h, w = state.shape
    for name in ("mu", "sigma_sq", "a", "b", "ref_img"):
        kernels.require(getattr(state, name), name, (h, w))
    kernels.require(state.conv, "conv", (h, w), torch.int32)
    kernels.require(state.f_ref, "f_ref", (3, h, w))
    kernels.require(geo, "geo", (GEO_LEN,))
    kernels.require(acc, "acc", (ACC_LEN,), torch.int32)
    lib = kernels.library()
    stream = kernels.stream_of(state.mu)
    if cfg.straggler_slice:
        kernels.check(lib.remode_ref_fruitless(state.b.data_ptr(), acc.data_ptr(), h * w,
                                               cfg.b_init, stream), "ref_fruitless")
        kernels.count("ref_fruitless")
    stack = _grid(5, h, w, state.mu.device)
    err = lib.remode_ref_bands(
        state.mu.data_ptr(), state.sigma_sq.data_ptr(), state.a.data_ptr(),
        state.b.data_ptr(), state.conv.data_ptr(), state.ref_img.data_ptr(),
        state.f_ref.data_ptr(), geo.data_ptr(), acc.data_ptr(), stack.data_ptr(), h * w,
        cfg.sigma_band, cfg.min_search_depth, int(bool(cfg.straggler_slice)), cfg.b_init,
        cfg.straggler_after, 2.0 * cfg.coarse_refine_radius + 2.0, cfg.max_epipolar_extent,
        stream)
    kernels.check(err, "ref_bands")
    kernels.count("ref_bands")
    return stack


def rect_bands(ref_r, u_s, v_s, geo: torch.Tensor, acc: torch.Tensor, height: int,
               width: int, cfg: RemodeConfig):
    """``(valid_r, disp_lo, disp_hi, kbase, H_shift)``; the last two are
    views of ``geo``, which the kernel's last block writes."""
    rh, rw = ref_r.shape[-2:]
    kernels.require(ref_r, "ref_r", (5, rh, rw))
    kernels.require(u_s, "u_s", (rh, rw))
    kernels.require(v_s, "v_s", (rh, rw))
    kernels.require(geo, "geo", (GEO_LEN,))
    kernels.require(acc, "acc", (ACC_LEN,), torch.int32)
    valid_r, disp_lo, disp_hi = (_grid(rh, rw, ref_r.device) for _ in range(3))
    err = kernels.library().remode_rect_bands(
        ref_r.data_ptr(), u_s.data_ptr(), v_s.data_ptr(), geo.data_ptr(), acc.data_ptr(),
        valid_r.data_ptr(), disp_lo.data_ptr(), disp_hi.data_ptr(), rh * rw, height, width,
        cfg.max_epipolar_extent, int(bool(cfg.disp_rebase)), kernels.stream_of(ref_r))
    kernels.check(err, "rect_bands")
    kernels.count("rect_bands")
    return valid_r, disp_lo, disp_hi, geo[GEO["kbase"]], _mat(geo, "H_shift")


def rect_rebase(curr_img_r, ref_img_r, valid_r, disp_lo, disp_hi, xlim_raw, geo: torch.Tensor,
                acc: torch.Tensor, cfg: RemodeConfig):
    """``(k_lo, k_hi, xlim, coarse_args, gate)``: ``disp_lo`` and
    ``disp_hi`` rebased in place and returned."""
    rh, rw = valid_r.shape
    pad = cfg.disp_pad
    for name, t in (("ref_img_r", ref_img_r), ("valid_r", valid_r), ("disp_lo", disp_lo),
                    ("disp_hi", disp_hi)):
        kernels.require(t, name, (rh, rw))
    kernels.require(curr_img_r, "curr_img_r", (rh, rw + 2 * pad))
    kernels.require(xlim_raw, "xlim_raw", (rh, 2))
    kernels.require(geo, "geo", (GEO_LEN,))
    kernels.require(acc, "acc", (ACC_LEN,), torch.int32)
    dev = valid_r.device
    xlim = _grid(rh, 2, dev)
    coarse = bool(cfg.coarse_to_fine)
    half = {}
    gate = None
    if coarse:
        half = dict(curr_h=_grid(rh, rw // 2 + pad, dev), ref_h=_grid(rh, rw // 2, dev),
                    valid_h=_grid(rh, rw // 2, dev), xlim_h=_grid(rh, 2, dev),
                    lo_h=_grid(rh, rw // 2, dev), hi_h=_grid(rh, rw // 2, dev))
        gate = torch.empty((), dtype=torch.bool, device=dev)

    def ptr(name):
        return half[name].data_ptr() if coarse else None

    err = kernels.library().remode_rect_rebase(
        curr_img_r.data_ptr(), ref_img_r.data_ptr(), valid_r.data_ptr(), disp_lo.data_ptr(),
        disp_hi.data_ptr(), xlim_raw.data_ptr(), geo.data_ptr(), acc.data_ptr(),
        xlim.data_ptr(), ptr("curr_h"), ptr("ref_h"), ptr("valid_h"), ptr("xlim_h"),
        ptr("lo_h"), ptr("hi_h"), gate.data_ptr() if coarse else None, rh, rw, pad,
        2.0 * cfg.coarse_refine_radius + 2.0, 0.5 * (cfg.patch_side // 2) + 1.0, int(coarse),
        kernels.stream_of(valid_r))
    kernels.check(err, "rect_rebase")
    kernels.count("rect_rebase")
    coarse_args = None
    if coarse:
        pad_h = cfg.disp_pad // 2
        coarse_args = (half["curr_h"], half["xlim_h"], half["ref_h"], half["valid_h"],
                       half["lo_h"], half["hi_h"], cfg.ncc_threshold,
                       min(pad_h - 1, cfg.num_planes // 2 + 1), pad_h, cfg.patch_side, False)
    return disp_lo, disp_hi, xlim, coarse_args, gate


def coarse_narrow(d_c, found_c, disp_lo, disp_hi, cfg: RemodeConfig, gate: torch.Tensor):
    """``disp_lo`` and ``disp_hi`` narrowed in place and returned."""
    rh, rw = disp_lo.shape
    kernels.require(disp_hi, "disp_hi", (rh, rw))
    kernels.require(disp_lo, "disp_lo", (rh, rw))
    kernels.require(d_c, "d_c", (rh, rw // 2))
    kernels.require(found_c, "found_c", (rh, rw // 2), torch.bool)
    kernels.require(gate, "gate", (), torch.bool)
    err = kernels.library().remode_coarse_narrow(
        d_c.data_ptr(), found_c.data_ptr(), gate.data_ptr(), disp_lo.data_ptr(),
        disp_hi.data_ptr(), rh, rw, cfg.coarse_refine_radius, kernels.stream_of(disp_lo))
    kernels.check(err, "coarse_narrow")
    kernels.count("coarse_narrow")
    return disp_lo, disp_hi


def back_stack(disp, ncc, found, kbase) -> torch.Tensor:
    """The back-warp's input [3, H, W]."""
    rh, rw = disp.shape
    kernels.require(disp, "disp", (rh, rw))
    kernels.require(ncc, "ncc", (rh, rw))
    kernels.require(found, "found", (rh, rw), torch.bool)
    kernels.require(kbase, "kbase", ())
    out = _grid(3, rh, rw, disp.device)
    err = kernels.library().remode_back_stack(
        disp.data_ptr(), ncc.data_ptr(), found.data_ptr(), kbase.data_ptr(), out.data_ptr(),
        rh * rw, kernels.stream_of(disp))
    kernels.check(err, "back_stack")
    kernels.count("back_stack")
    return out
