"""One keyframe recomputed from the raw inputs: the flat reseed on its
reference frame, one frame step per update frame, then the TV-L1 denoise.
The frame step is a frozen copy of rpg_open_remode_tpu_torch/models/
depthmap.update_step; the matcher's regime is chosen on the host from the
keyframe pose and mean depth, as the program's engine chooses it.

``precision`` selects the control: "fp32" is the reference; "tf32" lets
float32 matrix products round to TF32; "bf16" rounds the filter state (mu,
sigma_sq, a, b) to bfloat16 after the reseed and after every frame, as a
state stored in bfloat16 would be.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from benchmark.reference import filter as flt
from benchmark.reference import geometry as geo
from benchmark.reference import match as mt
from benchmark.reference.config import UPDATE, Config
from benchmark.reference.denoise import denoise

PRECISIONS = ("fp32", "tf32", "bf16")


def prep_image(img):
    return img.float() / 255.0 if img.dtype == torch.uint8 else img.float()


def update_step(state, curr_img, T_curr_world, cam, cfg: Config, regime: int, observe=None):
    curr_img = prep_image(curr_img)
    height, width = curr_img.shape
    T_curr_ref = geo.compose(T_curr_world, state.T_world_ref)
    border = flt.border_mask(height, width, cfg, device=curr_img.device)
    conv1 = flt.classify_seeds(state.mu, state.sigma_sq, state.a, state.b,
                               state.scene.epsilon, border, cfg)
    state = dataclasses.replace(state, conv=conv1)
    result = mt.match(state, curr_img, T_curr_ref, cam, cfg, regime, observe)
    active = conv1 == UPDATE
    conv2 = flt.apply_match_to_conv(conv1, active, result.found)
    return flt.update_seeds(state, conv2, result.u, result.v, geo.inv(T_curr_ref), cam, cfg)


def _round_bf16(state):
    def r(x):
        return x.to(torch.bfloat16).to(torch.float32)

    return dataclasses.replace(state, mu=r(state.mu), sigma_sq=r(state.sigma_sq),
                               a=r(state.a), b=r(state.b))


@contextlib.contextmanager
def _matmul_tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@dataclasses.dataclass
class Camera:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


def replay_keyframe(images, poses, bounds, frames, camera: Camera, cfg: Config, device,
                    precision: str = "fp32", observe=None, denoised: bool = True,
                    on_update=None):
    """Keyframe ``frames`` (bank indices: ``frames[0]`` the reference frame,
    the rest its updates in order) over the host bank ``images`` [N, H, W]
    uint8, ``poses`` [N, 3, 4] float32 T_curr_world and ``bounds`` [N, 2].
    Returns ``(state, denoised depth or None)``; ``observe(k, p)`` receives
    the sweep inputs of the k-th update when it takes the rectified branch;
    ``on_update(n, state, dist)`` is called after the n-th update with the
    camera's distance from the reference (a 0-d tensor), and a true return
    ends the replay there, with no denoised depth."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    with torch.no_grad(), _matmul_tf32(precision == "tf32"):
        cam = geo.PinholeCamera.create(camera.fx, camera.fy, camera.cx, camera.cy, device)
        f_ref = cam.bearing_grid(camera.height, camera.width)

        pose = torch.zeros((3, 4), dtype=torch.float32, device=device)

        def frame(i):
            # the pose copied into one buffer, as the program stages it: on
            # the CPU a 3x3 product can round differently for operands at
            # another alignment
            pose.copy_(torch.from_numpy(np.asarray(poses[i], np.float32)))
            return torch.tensor(images[i], device=device), pose

        img, T = frame(frames[0])
        scene = flt.SceneParams.from_bounds(
            torch.from_numpy(np.asarray(bounds[frames[0]], np.float32)).to(device), cfg)
        state = flt.init_seeds(f_ref, prep_image(img), geo.inv(T), scene, cfg)
        if precision == "bf16":
            state = _round_bf16(state)
        T_ref_host = state.T_world_ref.cpu().numpy()
        avg_host = np.float32(state.scene.avg_depth.cpu())
        fx, fy = np.float32(camera.fx), np.float32(camera.fy)
        for k, i in enumerate(frames[1:]):
            img, T = frame(i)
            regime = mt.regime_index(poses[i], T_ref_host, avg_host, fx, fy, camera.height,
                                     camera.width, cfg)
            hook = None if observe is None else (lambda p, k=k: observe(k, p))
            if on_update is not None:
                dist = torch.linalg.norm(geo.translation(geo.compose(T, state.T_world_ref)))
            state = update_step(state, img, T, cam, cfg, regime, hook)
            if precision == "bf16":
                state = _round_bf16(state)
            if on_update is not None and on_update(k + 1, state, dist):
                return state, None
        den = None
        if denoised:
            den = denoise(state.mu, state.a, state.b, state.sigma_sq, state.scene.depth_range,
                          cfg, lam=cfg.denoise_lambda, iterations=cfg.denoise_iters)
    return state, den
