"""Work accounting for the port's CUDA disparity sweep (counterpart of
``rpg_open_remode_tpu/ops/accounting.py``).

The JAX version counts what its Pallas kernel executes: per-block plane
intervals over 64-row bands, rounded up to GROUP-unrolled plane groups, and
the MXU matmuls of its box sums, against TPU v5e peaks. None of that exists
on the card. ``csrc/sweep.cu`` computes each pixel's admitted plane interval
(band, plane cap, footprint limit ``xlim``) at pixels whose reference patch
passes the guards, and scores exactly those (pixel, plane) pairs, spread
over each tile's threads; its patch sums are direct taps on the CUDA cores
in fp32, not matrix products. So this module counts pairs, not block hulls,
and has no MXU figures:

  - ``pairs``: the (pixel, plane) pairs the kernel scores;
  - ``band_pairs``: the integer planes of each guarded pixel's band under
    the plane cap, before the footprint cut;
  - ``pixel_ideal_plane_px``: the sum of every banded pixel's own band
    width, ``disp_hi - disp_lo + 1`` (as in the JAX record);
  - ``pairs_full``: ``num_planes`` x rect pixels, the whole cost volume;
  - the coarse pass's pairs, weighted by whether it runs on the frame.

``sweep_counts`` re-runs the port's own ``classify_seeds`` and
``prepare_sweep`` on a snapshot of the engine state, so the counts come from
the exact kernel inputs with no instrumentation on the hot path (the coarse
pass runs inside ``prepare_sweep``, as on the main path).

FLOPs: ``flops`` is the JAX record's algorithmic count, what the ZNCC
function needs: a minimal separable ZNCC (three box sums at 4 hp adds each,
the curr x ref product, ~10 ZNCC ops) = 12 hp + 11 per scored pair. The
bound (``bound_ms``) takes it. ``flops_exec`` is what the CUDA kernel does,
three direct patch sums (5 operations a tap) and ~12 of ZNCC and masks per
pair, plus the template statistics (4 a tap) per swept pixel: more than the
function needs, so it bounds nothing. The shares of peak are taken against
the card's fp32 rate outside the tensor cores.
"""

from __future__ import annotations

import dataclasses

import torch

from rpg_open_remode_tpu_torch.config import RemodeConfig
from rpg_open_remode_tpu_torch.models.depthmap import prep_image, to_device
from rpg_open_remode_tpu_torch.models.state import SeedState
from rpg_open_remode_tpu_torch.ops import rect_match, seed_check
from rpg_open_remode_tpu_torch.ops.sweep_cuda import box_zero
from rpg_open_remode_tpu_torch.utils import se3
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera

# NVIDIA H100 80GB HBM3 (SXM) data sheet: fp32 outside the tensor cores, HBM
PEAK_FP32_TFLOPS = 67.0
PEAK_HBM_GBPS = 3350.0


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least milliseconds the card needs to move ``nbytes`` and do
    ``flops`` at its data-sheet peaks, and which of the two bounds it
    (``"bytes"`` or ``"operations"``)."""
    t_b = nbytes / (PEAK_HBM_GBPS * 1e9) * 1e3
    t_f = flops / (PEAK_FP32_TFLOPS * 1e12) * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def call_work(curr_pad, xlim, ref_img, valid, disp_lo, disp_hi, ncc_threshold,
              num_planes: int, pad: int, patch_side: int, subplane_refine) -> dict:
    """What one ``disparity_sweep`` call (its arguments) needs. ``pairs``,
    ``pixels`` (with at least one pair), ``band_pairs``, ``band`` (each
    guarded pixel's band-plane count, a tensor), ``flops`` (the ZNCC's
    algorithmic count, 12 hp + 11 a pair), ``flops_exec`` (the kernel's own
    count) and ``bytes`` (each input read once, each output written
    once)."""
    area = patch_side * patch_side
    h, w = ref_img.shape
    st = box_zero(ref_img, patch_side)
    denom = area * box_zero(ref_img * ref_img, patch_side) - st * st
    ref_ok = (box_zero((valid > 0.999).float(), patch_side) > area - 0.5) & (denom > 1e-10)
    # band [dlo - 0.5, dhi + 0.5] and the cap [0, K - 1] in integer planes
    klo = torch.clamp(torch.ceil(disp_lo - 0.5), min=0.0)
    khi = torch.clamp(torch.floor(disp_hi + 0.5), max=num_planes - 1.0)
    # footprint: x - k in [xmin, xmax]; the ends from the float bounds, then
    # fixed with the exact test the sweep applies
    x = torch.arange(w, device=ref_img.device, dtype=torch.float32)[None, :]
    xmin, xmax = xlim[:, 0:1], xlim[:, 1:2]
    k0 = torch.ceil(x - xmax)
    k0 = torch.where(x - k0 > xmax, k0 + 1.0, k0)
    k0 = torch.where(x - (k0 - 1.0) <= xmax, k0 - 1.0, k0)
    k1 = torch.floor(x - xmin)
    k1 = torch.where(x - k1 < xmin, k1 - 1.0, k1)
    k1 = torch.where(x - (k1 + 1.0) >= xmin, k1 + 1.0, k1)
    k0 = torch.maximum(klo, k0)
    k1 = torch.minimum(khi, k1)
    zero = torch.zeros_like(klo)
    swept = ref_ok & (klo <= khi)
    band = torch.where(swept, khi - klo + 1, zero)
    n_pair = torch.where(swept & (k0 <= k1), k1 - k0 + 1, zero)
    pairs = float(n_pair.sum())
    return dict(pairs=pairs, pixels=float((n_pair > 0).sum()), band_pairs=float(band.sum()),
                band=band, flops=pairs * (12.0 * (patch_side // 2) + 11.0),
                flops_exec=pairs * (5 * area + 12) + float(swept.sum()) * 4 * area,
                bytes=4 * (curr_pad.numel() + xlim.numel() + 6 * h * w) + h * w)


def planesweep_work(th: int, tw: int, height: int, width: int, num_planes: int,
                    patch_side: int) -> dict:
    """What one plane-sweep call (``ops/planesweep_cuda``) on a ``th x tw``
    tile against a ``height x width`` current image needs: ``pairs``, every
    (pixel, plane) pair the plain loop scores; ``flops``, the ZNCC's
    algorithmic 12 hp + 11 a pair; ``bytes``, each input read once (the
    window's reference pixels and three bearing planes, mu, sigma_sq, the two
    template planes, the current image) and each output written once
    (found, 1 byte; u, v, best NCC)."""
    p = patch_side // 2
    ext = (th + 2 * p) * (tw + 2 * p)
    pairs = float(th * tw * num_planes)
    return dict(pairs=pairs, flops=pairs * (12.0 * p + 11.0),
                bytes=4 * (4 * ext + 4 * th * tw + height * width) + 13 * th * tw)


def sweep_counts(state: SeedState, curr_img, T_curr_world, cam: PinholeCamera,
                 cfg: RemodeConfig) -> dict:
    """The sweep work the next update of ``state`` on this frame does:
    classify as ``update_step`` does, then the sweep inputs from
    ``prepare_sweep``. Host floats."""
    curr_img = prep_image(curr_img)
    height, width = curr_img.shape
    T_curr_ref = se3.compose(T_curr_world, state.T_world_ref)
    border = seed_check.border_mask(height, width, cfg, device=curr_img.device)
    conv1 = seed_check.classify_seeds(
        state.mu, state.sigma_sq, state.a, state.b, state.scene.epsilon, border, cfg)
    state = dataclasses.replace(state, conv=conv1)
    p = rect_match.prepare_sweep(state, curr_img, T_curr_ref, cam, cfg)
    fine = call_work(p["curr_img_r"], p["xlim"], p["ref_img_r"], p["valid_r"], p["disp_lo"],
                     p["disp_hi"], cfg.ncc_threshold, cfg.num_planes, cfg.disp_pad,
                     cfg.patch_side, cfg.subplane_refine)
    # the coarse pass is launched on every frame; its gate says whether it
    # worked (a pass gated off writes "not found" and scores nothing)
    fired = p["gate"] is not None and bool(p["gate"])
    coarse = (call_work(*p["coarse_args"]) if fired
              else dict(pairs=0.0, flops=0.0, flops_exec=0.0, bytes=0.0))
    lo, hi = p["disp_lo"], p["disp_hi"]
    ideal = torch.where(torch.isfinite(lo) & (hi >= lo), hi - lo + 1.0, torch.zeros_like(lo))
    rect_h, rect_w = p["ref_img_r"].shape
    return dict(
        pairs=fine["pairs"], pixels=fine["pixels"], band_pairs=fine["band_pairs"],
        pixel_ideal_plane_px=float(ideal.sum()), pairs_full=float(cfg.num_planes * rect_h * rect_w),
        coarse_pairs=coarse["pairs"], coarse_fired=fired,
        flops=fine["flops"] + coarse["flops"], flops_exec=fine["flops_exec"] + coarse["flops_exec"],
        bytes=fine["bytes"] + coarse["bytes"],
        shape=(rect_h, rect_w),
    )


def frame_accounting(eng, img, T_curr_world, frame_s: float) -> dict:
    """The sweep record of one frame for the engine ``eng`` (a ``Depthmap``)
    and a measured per-frame time ``frame_s``: counts, FLOPs and shares of
    the card's fp32 peak. ``mfu_pct`` takes the algorithmic FLOPs over the
    whole frame time (warps, classify and fusion included), as the JAX
    record does; ``exec_pct_of_peak`` the kernel's own."""
    T = to_device(T_curr_world, eng.device, pose=True)
    c = sweep_counts(eng.state, eng.input_image(img), T, eng.cam, eng.cfg)
    alg = c["flops"]
    peak = max(frame_s, 1e-9) * PEAK_FP32_TFLOPS * 1e12
    return {
        "pairs_swept": c["pairs"],
        "band_pairs": c["band_pairs"],
        "pairs_full": c["pairs_full"],
        "skip_ratio": round(c["pairs"] / max(c["pairs_full"], 1.0), 4),
        "coarse_pairs": c["coarse_pairs"],
        "coarse_fired": c["coarse_fired"],
        "pixel_ideal_plane_px": c["pixel_ideal_plane_px"],
        "pairs_over_ideal": round(c["pairs"] / max(c["pixel_ideal_plane_px"], 1.0), 4),
        "est_tflops": round(alg / 1e12, 5),
        "sweep_gflops_alg": round(alg / 1e9, 4),
        "sweep_gflops_exec": round(c["flops_exec"] / 1e9, 4),
        "sweep_bound_ms": bound_ms(c["bytes"], c["flops"])[0],
        "mfu_pct": round(100.0 * alg / peak, 3),
        "exec_pct_of_peak": round(100.0 * c["flops_exec"] / peak, 3),
    }
