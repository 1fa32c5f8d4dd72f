"""Sub-phase timing of the rectified matcher (counterpart of the
repository's ``scripts_profile_match.py``).

The inputs are ``profile_update``'s (the bench's focal convention,
``RemodeConfig.for_camera(fx)``, the state after the warm-up frames); the
phases are measured on the first frame the warm-up did not consume:

  ref warp (6ch)    the reference stack (image, the band's three depths,
                    ones, the active mask) onto the rect grid
  curr warp (wide)  the current frame onto the padded rect grid
  sweep kernel      the disparity sweep on those (on a CUDA tensor, the CUDA
                    kernel of ``csrc/sweep.cu``)
  back-warp (3ch)   three rect planes back onto the reference grid

(each warp one launch of the fused kernel of ``csrc/warp.cu`` on a CUDA
tensor; the curr warp and the back-warp without u and v, as the matcher
calls them)
  FULL match        epipolar.match on frame i of 0 .. K - 1

with the same three columns as ``profile_update`` (K = 16 calls a phase;
``PROFILE_K`` and ``PROFILE_WARMUP`` in the environment override K and the
warm-up, as in the JAX script).

    python -m rpg_open_remode_tpu_torch.scripts.profile_match [WxH ...]
        [--device cuda|cpu] [--json PATH]
"""

from __future__ import annotations

import os
import sys

import torch

from rpg_open_remode_tpu_torch.scripts.profile_update import K, WARMUP, run_cli, setup


def profile(width, height, device="cuda", k=K, warmup=WARMUP):
    """The sub-phase rows at one size: ``(rows, rect_shape)``, each row
    ``{"phase", "device", "wall", "busy"}`` (ms a call)."""
    from rpg_open_remode_tpu_torch.config import ConvergenceState
    from rpg_open_remode_tpu_torch.models.depthmap import prep_image
    from rpg_open_remode_tpu_torch.ops import epipolar, rect_match, sweep_cuda
    from rpg_open_remode_tpu_torch.utils import se3
    from rpg_open_remode_tpu_torch.utils import warp as warp_ops
    from rpg_open_remode_tpu_torch.utils.profiling import force, phase_ms

    # the measured frame must exist and must not have been consumed by warmup
    if warmup >= k + 8:
        raise ValueError(f"warm-up {warmup} >= {k + 8} frames")
    x = setup(width, height, device, k, warmup)
    cfg, cam, imgs, Ts, state = x.cfg, x.cam, x.imgs, x.Ts, x.state
    M = warmup
    g = rect_match.rect_geometry(se3.compose(Ts[M], state.T_world_ref), cam, height, width)
    rect_h, rect_w = g["rect_h"], g["rect_w"]
    pad = cfg.disp_pad
    print(f"[{width}x{height}] warmup done; rect grid {rect_h}x{rect_w}", flush=True)

    sigma = torch.sqrt(state.sigma_sq)
    d_lo = torch.clamp(state.mu - cfg.sigma_band * sigma, min=cfg.min_search_depth)
    d_hi = state.mu + cfg.sigma_band * sigma
    rz = torch.clamp(torch.einsum("j,jhw->hw", g["R_rect"][2], state.f_ref), min=1e-3)
    active = (state.conv == int(ConvergenceState.UPDATE)).float()
    ref_stack = torch.stack([
        state.ref_img, torch.clamp(d_lo * rz, min=1e-4), torch.clamp(state.mu * rz, min=1e-4),
        torch.clamp(d_hi * rz, min=1e-4), torch.ones_like(state.mu), active])
    ref_r, _, _ = warp_ops.homography_warp(ref_stack, g["H_rect_to_ref"], rect_h, rect_w)
    xlim = rect_match._footprint_xlim(g["H_curr_to_rect"], height, width, rect_h,
                                      reach=cfg.patch_side // 2 + 1.5, vrows=cfg.patch_side)
    fxB = torch.abs(g["s"]) * g["B"]
    z_lo_r, z_mu_r, z_hi_r = ref_r[1], ref_r[2], ref_r[3]
    disp_lo = fxB / z_hi_r
    disp_hi = fxB / z_lo_r
    disp_mu = fxB / z_mu_r
    half = 0.5 * torch.clamp(disp_hi - disp_lo, max=cfg.max_epipolar_extent)
    disp_lo = torch.maximum(disp_lo, disp_mu - half)
    disp_hi = torch.minimum(disp_hi, disp_mu + half)
    act = ref_r[5] > 1e-3
    disp_lo = torch.where(act, disp_lo, torch.full_like(disp_lo, float("inf"))).contiguous()
    disp_hi = torch.where(act, disp_hi, torch.full_like(disp_hi, float("-inf"))).contiguous()
    curr_r, _, _ = warp_ops.homography_warp(prep_image(imgs[M]), g["H_rect_to_curr"], rect_h,
                                            rect_w + 2 * pad, x0=-float(pad))
    sweep_args = (curr_r.contiguous(), xlim.contiguous(), ref_r[0].contiguous(),
                  ref_r[4].contiguous(), disp_lo, disp_hi, cfg.ncc_threshold, cfg.num_planes,
                  pad, cfg.patch_side, cfg.subplane_refine)
    out_stack = torch.stack([ref_r[0], ref_r[4], ref_r[5]])
    force(curr_r)

    phases = [
        ("ref warp (6ch)", lambda i: warp_ops.homography_warp(
            ref_stack, g["H_rect_to_ref"], rect_h, rect_w)[0]),
        ("curr warp (wide)", lambda i: warp_ops.homography_warp(
            prep_image(imgs[i]), g["H_rect_to_curr"], rect_h, rect_w + 2 * pad,
            x0=-float(pad), want_uv=False)[0]),
        ("sweep kernel", lambda i: sweep_cuda.disparity_sweep(*sweep_args)[1]),
        ("back-warp (3ch)", lambda i: warp_ops.homography_warp(
            out_stack, g["H_ref_to_rect"], height, width, want_uv=False)[0]),
        ("FULL match", lambda i: epipolar.match(
            state, prep_image(imgs[i]), se3.compose(Ts[i], state.T_world_ref), cam,
            cfg).best_ncc),
    ]
    rows = [dict(phase=name, **phase_ms(fn, k, imgs.device)) for name, fn in phases]
    return rows, (rect_h, rect_w)


def main(argv=None) -> int:
    return run_cli(argv, __doc__.split("\n\n")[0], profile,
                   k=int(os.environ.get("PROFILE_K", K)),
                   warmup=int(os.environ.get("PROFILE_WARMUP", WARMUP)))


if __name__ == "__main__":
    sys.exit(main())
