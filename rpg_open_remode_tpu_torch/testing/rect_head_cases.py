"""Inputs and holds for the rectified step's head kernels
(``ops/rect_head_cuda``) against their plain versions.

``lateral_stream`` gives the camera, the config and the first updates of a
lateral dolly of the synthetic scene from a flat keyframe, each as (the
state before it, its image, its pose). ``case`` turns one of them into the
inputs of a named case: ``gate_on`` (a young keyframe, whose wide bands turn
the coarse pass on), ``gate_off`` (the first update, whose short baseline
keeps the bands narrow), ``stragglers`` (a block of seeds with many
fruitless frames and a low inlier ratio, whose bands are sliced) and
``no_valid`` (every seed inactive: no rect pixel has a band, so kbase is 0).
``head_mismatches`` holds each piece of the head as it runs on the inputs'
device (its kernel on the card) against its plain version on the same
inputs, and ``rect_match``'s chains against the walk of the plain pieces,
and returns what differs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig
from rpg_open_remode_tpu_torch.models import depthmap as dm
from rpg_open_remode_tpu_torch.models.state import SceneParams, empty_state
from rpg_open_remode_tpu_torch.ops import rect_match, seed_check, seed_init
from rpg_open_remode_tpu_torch.ops.sweep_cuda import disparity_sweep
from rpg_open_remode_tpu_torch.utils import se3, synthetic
from rpg_open_remode_tpu_torch.utils import warp as warp_ops
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera

CASES = ("gate_on", "gate_off", "stragglers", "no_valid")
# the frame of lateral_stream each case starts from
CASE_STEP = {"gate_on": 3, "gate_off": 0, "stragglers": 3, "no_valid": 3}


def _Tcw(fr) -> np.ndarray:
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


def lateral_stream(width: int, height: int, device="cpu", n_updates: int = 5,
                   fx: float = 481.2, fy: float = -480.0):
    """(camera, config, steps): ``steps[i]`` is (the state before update
    i + 1, its uint8 image, its T_curr_world), the updates made by
    ``update_step`` in the rectified regime. The camera has focal lengths
    ``fx``, ``fy`` (the over-table one's by default) and is centred on the
    image; the config is ``for_camera(fx)``."""
    cam = dict(fx=fx, fy=fy, cx=(width - 1) / 2, cy=(height - 1) / 2)
    frames = synthetic.generate(n_frames=n_updates + 1, width=width, height=height, cam=cam,
                                seed=1)
    cfg = RemodeConfig.for_camera(cam["fx"])
    pcam = PinholeCamera.create(**cam, device=device)
    f0 = frames[0]
    d = f0.depth[np.isfinite(f0.depth)]
    state = seed_init.init_seeds(
        empty_state(height, width, pcam), torch.tensor(f0.image).to(device),
        torch.tensor(f0.T_world_curr).to(device),
        SceneParams.create(d.min(), d.max(), cfg, device=device), cfg)
    steps = []
    for fr in frames[1:]:
        img, T = torch.tensor(fr.image).to(device), torch.tensor(_Tcw(fr)).to(device)
        steps.append((state, img, T))
        state, _ = dm.update_step(state, img, T, pcam, cfg, rect_match.RECTIFIED)
    return pcam, cfg, steps


def classified(state, cfg: RemodeConfig):
    """``state`` with its seeds classified as ``update_step`` does, by the
    plain composition."""
    h, w = state.shape
    border = seed_check.border_mask(h, w, cfg, device=state.mu.device)
    return dataclasses.replace(state, conv=seed_check.classify_seeds(
        state.mu, state.sigma_sq, state.a, state.b, state.scene.epsilon, border, cfg))


def case(step, cfg: RemodeConfig, name: str):
    """(classified state, prepped image, T_curr_ref) of case ``name`` from
    one of ``lateral_stream``'s steps."""
    state, img, T = step
    state = classified(state, cfg)
    h, w = state.shape
    if name == "stragglers":
        a, b = state.a.clone(), state.b.clone()
        a[h // 4: h // 2, w // 4: w // 2] *= 0.5
        b[h // 4: h // 2, w // 4: w // 2] += 13.0
        state = dataclasses.replace(state, a=a, b=b)
    elif name == "no_valid":
        state = dataclasses.replace(state, conv=torch.full_like(
            state.conv, int(ConvergenceState.CONVERGED)))
    return state, dm.prep_image(img), se3.compose(T, state.T_world_ref)


def runs(steps) -> list:
    """The (step index, case) pairs the card holds: every update of the
    stream (the first with the gate off, the rest on), then the straggler
    and no-valid cases."""
    out = [(i, "gate_off" if i == 0 else "gate_on") for i in range(len(steps))]
    return out + [(CASE_STEP[c], c) for c in ("stragglers", "no_valid")]


def _leaves(x, name=""):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{name}.{k}")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{name}[{i}]")
    else:
        yield name, x


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def mismatches(got, want) -> dict:
    """{leaf: (elements that differ, largest difference)} of the leaves of
    two nested results (dicts, tuples, tensors, plain values) that are not
    equal bit for bit."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    if g.keys() != w.keys():
        raise ValueError(f"different leaves: {sorted(g.keys() ^ w.keys())}")
    out = {}
    for name, b in w.items():
        a = g[name]
        if not isinstance(b, torch.Tensor):
            if a != b:
                out[name] = (a, b)
            continue
        if a.shape != b.shape or a.dtype != b.dtype:
            out[name] = (tuple(a.shape), a.dtype, tuple(b.shape), b.dtype)
            continue
        differ = _bits(a) != _bits(b)
        if bool(differ.any()):
            d = (a.double() - b.double()).abs()[differ]
            finite = torch.isfinite(d)
            out[name] = (int(differ.sum()), float(d[finite].max()) if bool(finite.any())
                         else float("inf"))
    return out


def head_mismatches(cam: PinholeCamera, cfg: RemodeConfig, state, img, T_curr_ref) -> dict:
    """Each piece of the rectified step's head (``seed_check.classify`` and
    the pieces ``rect_match.prepare_sweep`` chains), as it runs on the
    inputs' device (the hand kernels on the card), against its plain
    version on the same inputs, the plain outputs feeding the next piece;
    then ``rect_match``'s chains against that walk of the plain pieces.
    Returns {kernel or chain: its ``mismatches``} of those that differ."""
    rm = rect_match
    h, w = img.shape
    out = {}

    def hold(name, got, want):
        bad = mismatches(got, want)
        if bad:
            out[name] = bad

    hold("classify", seed_check.classify(state.mu, state.sigma_sq, state.a, state.b,
                                         state.scene.epsilon, cfg), classified(state, cfg).conv)
    g, xlim_raw = rm.geometry_plain(T_curr_ref, cam, h, w, cfg)
    g_k, xlim_k = rm.geometry(T_curr_ref, cam, h, w, cfg)
    hold("rect_geometry", ({k: g_k[k] for k in g}, xlim_k), (g, xlim_raw))
    stack = rm.ref_bands_plain(state, g, cfg)
    hold("ref_bands", rm.ref_bands(state, g_k, cfg), stack)
    rect_h, rect_w = g["rect_h"], g["rect_w"]
    ref_r, u_s, v_s = warp_ops.homography_warp(stack, g["H_rect_to_ref"], rect_h, rect_w)
    bands = rm.rect_bands_plain(ref_r, u_s, v_s, g, h, w, cfg)
    bands_k = rm.rect_bands(ref_r, u_s, v_s, g_k, h, w, cfg)
    hold("rect_bands", bands_k, bands)
    valid_r, lo, hi, kbase, H_shift = bands
    kbase_k = bands_k[3]
    pad = cfg.disp_pad
    curr_r, _, _ = warp_ops.homography_warp(img, H_shift, rect_h, rect_w + 2 * pad,
                                            x0=-float(pad), want_uv=False)
    rebased = rm.rebase_plain(curr_r, ref_r[0], valid_r, lo, hi, xlim_raw, kbase, cfg)
    # the kernels rebase and narrow in place: they take copies
    hold("rect_rebase", rm.rebase(curr_r, ref_r[0], valid_r, lo.clone(), hi.clone(), xlim_raw,
                                  kbase_k, g_k, cfg), rebased)
    k_lo, k_hi, xlim, coarse_args, gate = rebased
    if coarse_args is not None:
        d_c, _, found_c = disparity_sweep(*coarse_args, gate=gate)
        narrowed = rm.narrow_bands_plain(d_c, found_c, k_lo, k_hi, cfg, gate)
        hold("coarse_narrow",
             rm.narrow_bands(d_c, found_c, k_lo.clone(), k_hi.clone(), cfg, gate), narrowed)
        k_lo, k_hi = narrowed
    d, ncc, found = disparity_sweep(curr_r, xlim, ref_r[0], valid_r, k_lo, k_hi,
                                    cfg.ncc_threshold, cfg.num_planes, pad, cfg.patch_side,
                                    cfg.subplane_refine)
    back_in = rm.back_stack_plain(d, ncc, found, kbase)
    hold("back_stack", rm.back_stack(d, ncc, found, kbase_k), back_in)
    p = rm.prepare_sweep(state, img, T_curr_ref, cam, cfg)
    hold("prepare_sweep", dict(p, g={k: p["g"][k] for k in g}),
         dict(g=g, curr_img_r=curr_r, ref_img_r=ref_r[0], valid_r=valid_r, xlim=xlim,
              disp_lo=k_lo, disp_hi=k_hi, kbase=kbase, coarse_args=coarse_args, gate=gate))
    back, _, _ = warp_ops.homography_warp(back_in, g["H_ref_to_rect"], h, w, want_uv=False)
    hold("match_rectified_planes",
         tuple(rm.match_rectified_planes(state, img, T_curr_ref, cam, cfg)),
         (back, g["H_ref_to_rect"], g["H_rect_to_curr"]))
    return out
