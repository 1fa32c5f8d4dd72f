"""The tail of a frame step as one CUDA kernel (``csrc/seed_update.cu``) and
its plain PyTorch version: everything per reference pixel after the
matcher, with no neighbour read and no global dependency.

The plain version is the composition the frame step made before the
kernel: in the rectified regime ``rect_match.unrectify`` (renormalize the
back-warped planes, unrectify the matches), then
``epipolar.apply_match_to_conv`` (the post-match state transition),
``seed_update.update_seeds`` (triangulation, one-pixel-angle uncertainty,
Gaussian x Beta moment matching, the behind-camera and NaN sentinels,
NO_MATCH's outlier count), ``reduction.convergence_stats`` (the five state
counts) and the found-masked NCC plane that ``update_step`` averages. It
replaces no TPU kernel: XLA fused this tail in the JAX package; on the card
the plain composition is ~240 kernel launches a frame, ~210 of them over
the whole image.

Two flavours, chosen by the type of the match: a ``rect_match.RectPlanes``
(the rectified matcher stopped at its back-warp) or a ``MatchResult`` of
any other matcher (pure rotation, plane sweep, the mesh's tiles). On a CPU
tensor the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises. The kernel reads every input on the device, so a
CUDA graph captures it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rpg_open_remode_tpu_torch import kernels
from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig
from rpg_open_remode_tpu_torch.models.state import SeedState
from rpg_open_remode_tpu_torch.ops import epipolar, reduction, rect_match, seed_update
from rpg_open_remode_tpu_torch.ops.rect_match import RectPlanes
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera

# the counts' order: the ConvergenceState values 0 .. 4
COUNT_KEYS = ("update", "converged", "border", "diverged", "no_match")
assert all(int(ConvergenceState[k.upper()]) == i for i, k in enumerate(COUNT_KEYS))


def seed_update_plain(state: SeedState, match, T_ref_curr: torch.Tensor, cam: PinholeCamera,
                      cfg: RemodeConfig):
    """The plain composition. ``state.conv`` holds the classified seeds;
    ``match`` is a ``RectPlanes`` or a ``MatchResult``. Returns ``(state',
    counts, ncc)``: the updated state (its ``conv`` the post-match states),
    int32 ``[5]`` counts of each state in ``COUNT_KEYS`` order and the plane
    ``where(found, best_ncc, 0)``."""
    if isinstance(match, RectPlanes):
        match = rect_match.unrectify(match, cfg)
    conv1 = state.conv
    active = conv1 == int(ConvergenceState.UPDATE)
    conv2 = epipolar.apply_match_to_conv(conv1, active, match.found)
    new = seed_update.update_seeds(state, conv2, match.u, match.v, T_ref_curr, cam, cfg)
    stats = reduction.convergence_stats(conv2)
    counts = torch.stack([stats[k] for k in COUNT_KEYS])
    ncc = torch.where(match.found, match.best_ncc, torch.zeros_like(match.best_ncc))
    return new, counts, ncc


def fused_seed_update(state: SeedState, match, T_ref_curr: torch.Tensor, cam: PinholeCamera,
                      cfg: RemodeConfig):
    """The kernel on CUDA tensors, the plain version on CPU tensors; the
    arguments and the result are ``seed_update_plain``'s."""
    if not state.mu.is_cuda:
        return seed_update_plain(state, match, T_ref_curr, cam, cfg)
    return _launch(state, match, T_ref_curr, cam, cfg)


def _launch(state: SeedState, match, T_ref_curr, cam: PinholeCamera, cfg: RemodeConfig):
    h, w = state.shape
    plane = (h, w)
    for name in ("mu", "sigma_sq", "a", "b", "match_u", "match_v"):
        kernels.require(getattr(state, name), name, plane)
    kernels.require(state.conv, "conv", plane, torch.int32)
    kernels.require(state.f_ref, "f_ref", (3, h, w))
    kernels.require(T_ref_curr, "T_ref_curr", (3, 4))
    for name in ("fx", "fy", "cx", "cy"):
        kernels.require(getattr(cam, name), name, ())
    kernels.require(state.scene.depth_range, "depth_range", ())
    rectified = isinstance(match, RectPlanes)
    if rectified:
        kernels.require(match.back, "back", (3, h, w))
        kernels.require(match.H_ref_to_rect, "H_ref_to_rect", (3, 3))
        kernels.require(match.H_rect_to_curr, "H_rect_to_curr", (3, 3))
        back, h_ref_to_rect, h_rect_to_curr = match
        found = u = v = best_ncc = None
    else:
        kernels.require(match.found, "found", plane, torch.bool)
        for name in ("u", "v", "best_ncc"):
            kernels.require(getattr(match, name), name, plane)
        found, u, v, best_ncc = match
        back = h_ref_to_rect = h_rect_to_curr = None
    dev = state.mu.device
    out = {name: torch.empty(plane, dtype=torch.float32, device=dev)
           for name in ("mu", "sigma_sq", "a", "b", "match_u", "match_v")}
    conv = torch.empty(plane, dtype=torch.int32, device=dev)
    ncc = torch.empty(plane, dtype=torch.float32, device=dev)
    counts = torch.zeros(len(COUNT_KEYS), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    # the Python scalars of update_seeds, rounded to float32 as PyTorch
    # rounds a scalar operand of a float32 tensor
    rot = cfg.pose_noise_rot_deg
    trans = cfg.pose_noise_trans_m
    err = kernels.library().remode_seed_update(
        ptr(state.conv), ptr(state.mu), ptr(state.sigma_sq), ptr(state.a), ptr(state.b),
        ptr(state.f_ref), ptr(state.match_u), ptr(state.match_v),
        ptr(back), ptr(h_ref_to_rect), ptr(h_rect_to_curr),
        ptr(found), ptr(u), ptr(v), ptr(best_ncc),
        ptr(T_ref_curr), ptr(cam.fx), ptr(cam.fy), ptr(cam.cx), ptr(cam.cy),
        ptr(state.scene.depth_range),
        ptr(out["mu"]), ptr(out["sigma_sq"]), ptr(out["a"]), ptr(out["b"]), ptr(conv),
        ptr(out["match_u"]), ptr(out["match_v"]), ptr(ncc), ptr(counts),
        h, w, float(cfg.ncc_threshold),
        int(bool(rot)), seed_update.MAG3 * rot * (math.pi / 180.0),
        int(bool(trans)), seed_update.MAG3 * trans,
        int(rectified), kernels.stream_of(state.mu),
    )
    kernels.check(err, "seed_update")
    kernels.count("seed_update")
    return dataclasses.replace(state, conv=conv, **out), counts, ncc
