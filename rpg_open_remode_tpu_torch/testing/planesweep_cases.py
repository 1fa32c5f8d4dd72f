"""Inputs that hold the plane-sweep matcher (``ops/planesweep_cuda``) to its
plain version: consecutive frames of a forward (axial) dolly of the
synthetic scene, whose epipole lies inside the image, so every update takes
the ``PLANE_SWEEP`` regime.

``render_forward`` renders the frames; ``forward_sequence`` gives the
camera, the config, a keyframe's state after its first updates and the
frames that follow; ``tile_args`` cuts the whole
image's arguments (``epipolar.planesweep_args``) to a tile as the mesh's
degenerate tiles have them (``parallel/sharded.py``): the seed planes and the
halo-extended window tile-sized, the current image whole. ``narrowed``
shrinks the bands so that most planes of a tile score nowhere and the
kernel skips them.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from rpg_open_remode_tpu_torch.config import RemodeConfig
from rpg_open_remode_tpu_torch.models import depthmap as dm
from rpg_open_remode_tpu_torch.models.state import SceneParams, SeedState, empty_state
from rpg_open_remode_tpu_torch.ops import seed_check, seed_init
from rpg_open_remode_tpu_torch.utils import synthetic
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera

STEP = 0.023   # m a frame along the optical axis, the benchmark's forward dolly


def camera_for(width: int, height: int) -> dict:
    """The over-table camera (fx 481.2, fy -480) with its focal length scaled
    to widths below 640 px, the principal point centred."""
    s = min(width / 640.0, 1.0)
    return dict(fx=481.2 * s, fy=-480.0 * s, cx=(width - 1) / 2, cy=(height - 1) / 2)


def Tcw(fr) -> np.ndarray:
    """A synthetic frame's ``T_curr_world``, ``[3, 4]`` float32."""
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


def render_forward(width: int, height: int, n_frames: int, cam: dict, seed: int = 1) -> list:
    """``n_frames`` synthetic frames of the hardened scene (the benchmark's
    noise, vignette, textureless discs and two spheres) along the axial
    dolly."""
    return synthetic.generate(n_frames=n_frames, width=width, height=height, cam=cam,
                              seed=seed, motion="forward", step=STEP, noise_sigma=0.01,
                              vignette=0.15, n_textureless=3, n_spheres=2)


def forward_sequence(width: int, height: int, n_frames: int, device, cam: dict | None = None,
                     cfg: RemodeConfig | None = None, warmup: int = 2, seed: int = 1):
    """A keyframe on frame 0 of a forward dolly, updated by ``update_step`` on
    frames 1 .. ``warmup``; returns a namespace of ``cam``
    (``PinholeCamera``), ``cfg``, ``state`` and ``frames``, the
    ``(image, T_curr_world)`` of frames ``warmup + 1`` .. ``n_frames - 1``
    on ``device`` (float32 images)."""
    cam_kw = camera_for(width, height) if cam is None else cam
    cfg = RemodeConfig() if cfg is None else cfg
    frames = render_forward(width, height, n_frames, cam_kw, seed)
    pcam = PinholeCamera.create(**cam_kw, device=device)
    f0 = frames[0]
    d = f0.depth[np.isfinite(f0.depth)]
    state = seed_init.init_seeds(
        empty_state(height, width, pcam), torch.as_tensor(f0.image).to(device),
        torch.as_tensor(f0.T_world_curr, dtype=torch.float32).to(device),
        SceneParams.create(d.min(), d.max(), cfg, device=device), cfg)
    seq = [(dm.prep_image(torch.as_tensor(fr.image).to(device)),
            torch.as_tensor(Tcw(fr)).to(device)) for fr in frames[1:]]
    for img, T in seq[:warmup]:
        state, _ = dm.update_step(state, img, T, pcam, cfg)
    return types.SimpleNamespace(cam=pcam, cfg=cfg, state=state, frames=seq[warmup:])


def classified(state: SeedState, cfg: RemodeConfig) -> SeedState:
    """``state`` with ``conv`` the seeds' classification, as the frame step
    hands it to the matcher."""
    h, w = state.shape
    border = seed_check.border_mask(h, w, cfg, device=state.mu.device)
    conv = seed_check.classify_seeds(state.mu, state.sigma_sq, state.a, state.b,
                                     state.scene.epsilon, border, cfg)
    return dataclasses.replace(state, conv=conv)


def tile_args(args: tuple, y0: int, x0: int, th: int, tw: int) -> tuple:
    """The whole image's ``match_planesweep_tile`` arguments cut to the tile
    at ``(y0, x0)`` of ``th x tw`` pixels: the window and the seed planes
    sliced (contiguous), the scene, current image, pose, camera and config
    as they are."""
    ref_ext, f_ext, mu, sigma_sq, sum_templ, ctd, *rest = args
    cfg = rest[-1]
    p = cfg.patch_side // 2
    ey, ex = slice(y0, y0 + th + 2 * p), slice(x0, x0 + tw + 2 * p)
    ty, tx = slice(y0, y0 + th), slice(x0, x0 + tw)
    return (ref_ext[ey, ex].contiguous(), f_ext[:, ey, ex].contiguous(),
            *(x[ty, tx].contiguous() for x in (mu, sigma_sq, sum_templ, ctd)), *rest)


def narrowed(state: SeedState, factor: float) -> SeedState:
    """``state`` with every seed's variance times ``factor``: bands of a few
    planes, as converged seeds have."""
    return dataclasses.replace(state, sigma_sq=state.sigma_sq * factor)
