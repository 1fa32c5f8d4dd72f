"""The user-facing dense-mapping engine (counterpart of
``rpg_open_remode_tpu/models/depthmap.py``; the reference's ``rmd::Depthmap``,
include/rmd/depthmap.h:34-129, and ``SeedMatrix``, src/seed_matrix.cu).

Functional core plus a thin stateful facade. Per frame, ``update_step``
classifies the seeds, matches them (rectified NCC sweep), triangulates and
fuses the measurement. Given the matcher's regime (``regime``, chosen on
the host by ``ops/rect_match.regime_index``) it reads nothing on the host,
so the facade runs it as a captured CUDA graph (``models/programs.py``),
one replay a frame; the functional core stays eager, the oracle of the
replays. Pose convention: callers pass ``T_curr_world``; the
engine stores ``T_world_ref = inv(T_curr_world)`` at keyframe creation and
forms ``T_curr_ref = T_curr_world * T_world_ref`` per frame
(src/seed_matrix.cu:108,124).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rpg_open_remode_tpu_torch.config import RemodeConfig
from rpg_open_remode_tpu_torch.models import programs
from rpg_open_remode_tpu_torch.models.state import SceneParams, SeedState
from rpg_open_remode_tpu_torch.ops import denoise as denoise_ops
from rpg_open_remode_tpu_torch.ops import (
    epipolar, propagate, seed_check, seed_init, seed_update_cuda,
)
from rpg_open_remode_tpu_torch.utils import se3
from rpg_open_remode_tpu_torch.utils import warp as warp_ops
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera

# order of the per-frame metrics in stats["packed"]
PACKED_STATS_KEYS = (
    "update", "converged", "border", "diverged", "no_match",
    "dist_from_ref", "mean_ncc",
)


def prep_image(img: torch.Tensor) -> torch.Tensor:
    """uint8 -> float [0, 1] (depthmap.cpp:103-106); float images pass as
    float32."""
    if img.dtype == torch.uint8:
        return img.float() / 255.0
    return img.float()


def set_reference(state: SeedState, ref_img, T_curr_world, scene: SceneParams,
                  cfg: RemodeConfig) -> SeedState:
    """New keyframe (SeedMatrix::setReferenceImage, seed_matrix.cu:87-118)."""
    return seed_init.init_seeds(
        state, prep_image(ref_img), se3.inv(T_curr_world), scene, cfg
    )


def _set_reference_propagated(state: SeedState, ref_img, T_curr_world,
                              scene: SceneParams, cam: PinholeCamera,
                              cfg: RemodeConfig) -> SeedState:
    """New keyframe warm-started from the outgoing keyframe's posterior
    (``cfg.propagate_depth``; ``ops/propagate.py``)."""
    prior = propagate.propagate_depth(state, T_curr_world, scene, cam, cfg)
    return seed_init.init_seeds(
        state, prep_image(ref_img), se3.inv(T_curr_world), scene, cfg, prior=prior
    )


def update_step(state: SeedState, curr_img, T_curr_world, cam: PinholeCamera,
                cfg: RemodeConfig, regime: int | None = None):
    """One measurement frame (SeedMatrix::update, seed_matrix.cu:120-158).
    Returns ``(state', stats)``, stats a dict of 0-d tensors. ``regime`` is
    the rectified matcher's branch (``rect_match.regime_index``); None
    reads the device's choice on the host."""
    curr_img = prep_image(curr_img)
    T_curr_ref = se3.compose(T_curr_world, state.T_world_ref)
    dist_from_ref = torch.linalg.norm(se3.translation(T_curr_ref))

    # 1. classify (seedCheckKernel): one kernel on the card
    conv1 = seed_check.classify(
        state.mu, state.sigma_sq, state.a, state.b, state.scene.epsilon, cfg
    )
    state = dataclasses.replace(state, conv=conv1)

    # 2. epipolar NCC match (seedEpipolarMatchKernel); the rectified
    # matcher stops at its back-warp, which the fused tail finishes
    match = epipolar.match(state, curr_img, T_curr_ref, cam, cfg, regime, planes=True)

    # 3. post-match states, triangulation + Bayesian fusion
    # (seedUpdateKernel) and the state counts: one kernel on the card
    new_state, counts, ncc = seed_update_cuda.fused_seed_update(
        state, match, se3.inv(T_curr_ref), cam, cfg
    )

    stats = dict(zip(seed_update_cuda.COUNT_KEYS, counts.unbind()))
    stats["dist_from_ref"] = dist_from_ref
    stats["mean_ncc"] = torch.mean(ncc)
    stats["packed"] = torch.cat([counts.float(), torch.stack([dist_from_ref, stats["mean_ncc"]])])
    return new_state, stats


def update_chunk(state: SeedState, imgs, Ts_curr_world, cam: PinholeCamera,
                 cfg: RemodeConfig):
    """K frames in a row (offline replay). Returns ``(state', packed)``,
    ``packed[k]`` the frame-k metrics in ``PACKED_STATS_KEYS`` order."""
    packed = []
    for img, T in zip(imgs, Ts_curr_world):
        state, stats = update_step(state, img, T, cam, cfg)
        packed.append(stats["packed"])
    return state, torch.stack(packed)


def denoise_depthmap(state: SeedState, cfg: RemodeConfig, lam=None, iterations=None):
    """downloadDenoisedDepthmap (depthmap.cpp:113-123)."""
    return denoise_ops.denoise(
        state.mu, state.a, state.b, state.sigma_sq, state.scene.depth_range, cfg,
        lam=lam, iterations=iterations,
    )


def undistort_map(height: int, width: int, cam: PinholeCamera, k1, k2, p1, p2):
    """The rectification grid (cv::initUndistortRectifyMap in
    depthmap.cpp:45-61): the distorted source coordinate of every output
    pixel under the plumb-bob model."""
    dev = cam.fx.device
    v, u = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    x = (u - cam.cx) / cam.fx
    y = (v - cam.cy) / cam.fy
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return cam.fx * xd + cam.cx, cam.fy * yd + cam.cy


def to_device(x, device, pose: bool = False) -> torch.Tensor:
    """``x`` (an array, or a tensor on any device, e.g. a frame staged on
    the card) as a tensor on ``device``; a pose as float32."""
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32) if pose else x.to(device)
    return torch.as_tensor(np.asarray(x, np.float32) if pose else np.asarray(x)).to(device)


def _download(t: torch.Tensor) -> np.ndarray:
    """A host copy of a state buffer (on the CPU ``.numpy()`` would share
    the buffer, which later frames overwrite)."""
    return t.cpu().numpy() if t.is_cuda else t.numpy().copy()


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for and absent: the
    engine never drops to the CPU unless the caller passes ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev


class Depthmap:
    """Facade mirroring ``rmd::Depthmap`` (include/rmd/depthmap.h): owns the
    seed state on ``device`` in the buffers of its ``programs``; on the
    card ``set_reference_image``, ``update`` and each frame of
    ``update_chunk`` are one CUDA graph replay. Downloads happen only in
    ``depthmap()``, ``denoised_depthmap()``, ``convergence_map()`` and
    ``converged_percentage()``."""

    def __init__(self, width: int, height: int, fx: float, cx: float, fy: float,
                 cy: float, cfg: RemodeConfig | None = None, device=None):
        self.width = width
        self.height = height
        self.device = resolve_device(device)
        self.cam = PinholeCamera.create(fx, fy, cx, cy, device=self.device)
        # no explicit cfg: scale the reference constants to the focal length
        self.programs = programs.Programs(height, width, self.cam, (fx, fy),
                                          cfg or RemodeConfig.for_camera(fx), self.device)
        self._has_reference = False
        self._undistort_grid = None

    @property
    def cfg(self) -> RemodeConfig:
        """The engine's config, which its programs own."""
        return self.programs.cfg

    @property
    def state(self) -> SeedState:
        """A device copy of the seed state made at this read: later frames
        and keyframes, which the programs write into the same buffers, do
        not change it. Assigning a state restores it."""
        return self.programs.snapshot()

    @state.setter
    def state(self, state: SeedState) -> None:
        self.restore(state)

    def _tensor(self, x) -> torch.Tensor:
        return to_device(x, self.device)

    def init_undistortion_map(self, k1, k2, p1, p2) -> None:
        self._undistort_grid = undistort_map(
            self.height, self.width, self.cam, k1, k2, p1, p2
        )

    def input_image(self, img) -> torch.Tensor:
        """8-bit -> float [0, 1], then the optional undistortion remap (what
        the programs do to their input, eagerly)."""
        img = prep_image(self._tensor(img))
        if self._undistort_grid is not None:
            gu, gv = self._undistort_grid
            img = warp_ops.warp_grid(img, gu, gv)
        return img

    def restore(self, state: SeedState) -> None:
        """Adopt a keyframe state (e.g. one carried across with
        ``state_from_numpy``): copied into the engine's buffers."""
        if state.shape != (self.height, self.width):
            raise ValueError(f"state shape {state.shape} != {(self.height, self.width)}")
        self.programs.load(state)
        self._has_reference = True

    def set_reference_image(self, img, T_curr_world, min_depth, max_depth) -> bool:
        """New keyframe. With ``cfg.propagate_depth`` and a previous keyframe
        (and no undistortion grid, as in the JAX facade), the seeds are
        warm-started from the outgoing posterior; otherwise flat."""
        propagated = (self._undistort_grid is None and self.cfg.propagate_depth
                      and self._has_reference)
        self.programs.set_reference(img, T_curr_world, min_depth, max_depth, propagated,
                                    self._undistort_grid)
        self._has_reference = True
        return True

    def update(self, img, T_curr_world) -> dict:
        """One measurement frame; returns the frame's stats (a fresh packed
        ``[7]`` vector under ``packed`` and a float32 0-d view of it per
        key of ``PACKED_STATS_KEYS``)."""
        if not self._has_reference:
            raise RuntimeError("set_reference_image must be called first")
        return self.programs.update(img, T_curr_world, self._undistort_grid)

    def update_chunk(self, imgs, Ts_curr_world) -> torch.Tensor:
        """K frames (``imgs`` [K, H, W], ``Ts_curr_world`` [K, 3, 4]), one
        replay each with no host read between them; returns the ``[K, 7]``
        packed metrics on the device."""
        if not self._has_reference:
            raise RuntimeError("set_reference_image must be called first")
        return self.programs.update_chunk(imgs, Ts_curr_world, self._undistort_grid)

    def depthmap(self) -> np.ndarray:
        return _download(self.programs.state.mu)

    def denoised_depthmap(self, lam: float = 0.5, iterations: int = 200) -> np.ndarray:
        return denoise_depthmap(self.programs.state, self.cfg, lam=lam,
                                iterations=iterations).cpu().numpy()

    def convergence_map(self) -> np.ndarray:
        return _download(self.programs.state.conv)

    def reference_image(self) -> np.ndarray:
        """The keyframe image, float [0, 1] (getReferenceImage,
        depthmap.cpp:141-145)."""
        return _download(self.programs.state.ref_img)

    def converged_percentage(self) -> float:
        """getConvergedPercentage (depthmap.cpp:150-154)."""
        return float(self.programs.state.converged_fraction()) * 100.0

    @staticmethod
    def scale_mat(depth: np.ndarray) -> np.ndarray:
        """Min-max normalize to [0, 1] for display (depthmap.cpp:158-169)."""
        lo, hi = float(np.min(depth)), float(np.max(depth))
        if hi <= lo:
            return np.zeros_like(depth)
        return (depth - lo) / (hi - lo)
