"""The sweep's work and its least time on the card. Frozen copy of
rpg_open_remode_tpu_torch/ops/accounting.py (``bound_ms``, ``call_work``,
the peaks); ``box_zero`` is the benchmark reference's.

A pair is one (rect pixel, integer disparity plane) that the sweep scores:
each guarded pixel's band [dlo - 0.5, dhi + 0.5] under the plane cap and
the footprint limit ``xlim``. The operations are what the ZNCC needs, a
separable box-sum ZNCC at 12 hp + 11 a scored pair (hp = patch_side // 2);
the bytes read each input once and write each output once. So the count is
the work that these disparity bands need, whatever implements the match.
"""

from __future__ import annotations

import torch

from benchmark.reference.geometry import box_zero

# NVIDIA H100 80GB HBM3 (SXM) data sheet: fp32 outside the tensor cores, HBM
PEAK_FP32_TFLOPS = 67.0
PEAK_HBM_GBPS = 3350.0


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least milliseconds to move ``nbytes`` and do ``flops`` at the
    data-sheet peaks, and which of the two bounds it."""
    t_b = nbytes / (PEAK_HBM_GBPS * 1e9) * 1e3
    t_f = flops / (PEAK_FP32_TFLOPS * 1e12) * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def call_work(curr_pad, xlim, ref_img, valid, disp_lo, disp_hi, ncc_threshold,
              num_planes: int, pad: int, patch_side: int, subplane_refine) -> dict:
    """What one sweep call (its arguments) needs: ``pairs``, ``flops`` and
    ``bytes``."""
    area = patch_side * patch_side
    h, w = ref_img.shape
    st = box_zero(ref_img, patch_side)
    denom = area * box_zero(ref_img * ref_img, patch_side) - st * st
    ref_ok = (box_zero((valid > 0.999).float(), patch_side) > area - 0.5) & (denom > 1e-10)
    klo = torch.clamp(torch.ceil(disp_lo - 0.5), min=0.0)
    khi = torch.clamp(torch.floor(disp_hi + 0.5), max=num_planes - 1.0)
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
    n_pair = torch.where(swept & (k0 <= k1), k1 - k0 + 1, zero)
    pairs = float(n_pair.sum())
    return dict(pairs=pairs, flops=pairs * (12.0 * (patch_side // 2) + 11.0),
                bytes=4 * (curr_pad.numel() + xlim.numel() + 6 * h * w) + h * w)


def frame_bound_ms(p: dict, cfg) -> float:
    """The least time of one rectified frame's sweeps, from its sweep inputs
    ``p`` (the reference's ``prepare_sweep``): the full pass, and the coarse
    pass where its gate is on (a pass gated off reads its gate and scores
    nothing)."""
    fine = call_work(p["curr_img_r"], p["xlim"], p["ref_img_r"], p["valid_r"], p["disp_lo"],
                     p["disp_hi"], cfg.ncc_threshold, cfg.num_planes, cfg.disp_pad,
                     cfg.patch_side, cfg.subplane_refine)
    total = bound_ms(fine["bytes"], fine["flops"])[0]
    if p["gate"] is not None and bool(p["gate"]):
        coarse = call_work(*p["coarse_args"])
        total += bound_ms(coarse["bytes"], coarse["flops"])[0]
    return total
