"""Engine state: frozen dataclasses of tensors (counterpart of
``rpg_open_remode_tpu/models/state.py``).

The reference keeps this state as mutable pitched device buffers owned by
``SeedMatrix`` (include/rmd/seed_matrix.cuh:87-108). Here one frozen
``SeedState`` is replaced per frame; every image-shaped field is ``[H, W]``.
``state_from_numpy``/``state_to_numpy`` carry a state across from and to the
JAX package as numpy arrays, ``states_from_numpy`` a JAX keyframe ring's
batched state. ``copy_into`` writes a state into a persistent set of
buffers (the fixed addresses a captured CUDA graph reads and writes,
``models/programs.py``) and ``clone`` copies one out.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig
from rpg_open_remode_tpu_torch.utils import se3
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera


@dataclasses.dataclass(frozen=True)
class SceneParams:
    """Per-keyframe scene depth statistics (mvs_device_data.cuh:30-37 plus
    the derived scalars of seed_matrix.cu:96-104); 0-d float32 tensors."""

    min_depth: torch.Tensor
    max_depth: torch.Tensor
    avg_depth: torch.Tensor
    depth_range: torch.Tensor
    sigma_sq_max: torch.Tensor
    epsilon: torch.Tensor

    @classmethod
    def create(cls, min_depth, max_depth, cfg: RemodeConfig, device=None) -> "SceneParams":
        bounds = torch.tensor([float(min_depth), float(max_depth)], dtype=torch.float32,
                              device=device)
        return cls.from_bounds(bounds, cfg)

    @classmethod
    def from_bounds(cls, bounds: torch.Tensor, cfg: RemodeConfig) -> "SceneParams":
        """From a float32 ``[2]`` tensor (min depth, max depth) on the
        device, by device operations only."""
        min_d, max_d = bounds[0], bounds[1]
        rng = max_d - min_d
        return cls(
            min_depth=min_d,
            max_depth=max_d,
            avg_depth=(min_d + max_d) / 2.0,
            depth_range=rng,
            sigma_sq_max=rng * rng * cfg.sigma_sq_max_factor,
            # the reference compares sigma_sq against range/1000 directly
            # (dimensionally odd but load-bearing): seed_matrix.cu:104
            epsilon=rng * cfg.epsilon_factor,
        )


@dataclasses.dataclass(frozen=True)
class SeedState:
    """Full per-keyframe filter state. Image-shaped fields are ``[H, W]``
    float32 except ``conv`` (int32); ``f_ref`` is ``[3, H, W]``."""

    ref_img: torch.Tensor            # reference keyframe, [0, 1]
    sum_templ: torch.Tensor          # patch sums of ref_img
    const_templ_denom: torch.Tensor  # N*sum(t^2) - sum(t)^2 per pixel
    f_ref: torch.Tensor              # [3, H, W] normalized bearings
    mu: torch.Tensor                 # depth mean (along-ray)
    sigma_sq: torch.Tensor           # depth variance
    a: torch.Tensor                  # Beta inlier evidence
    b: torch.Tensor                  # Beta outlier evidence
    conv: torch.Tensor               # ConvergenceState, int32
    match_u: torch.Tensor            # last epipolar match, x pixel coord
    match_v: torch.Tensor            # last epipolar match, y pixel coord
    T_world_ref: torch.Tensor        # (3, 4) keyframe pose
    scene: SceneParams

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.mu.shape)

    def converged_fraction(self) -> torch.Tensor:
        """Fraction of seeds in CONVERGED state (src/reduction.cu:80-173)."""
        return (self.conv == int(ConvergenceState.CONVERGED)).float().mean()


def empty_state(height: int, width: int, cam: PinholeCamera) -> SeedState:
    """A zeroed state (before any reference frame is set)."""
    dev = cam.fx.device
    z = torch.zeros((height, width), dtype=torch.float32, device=dev)
    return SeedState(
        ref_img=z,
        sum_templ=z,
        const_templ_denom=z,
        f_ref=cam.bearing_grid(height, width),
        mu=z,
        sigma_sq=z,
        a=z,
        b=z,
        conv=torch.zeros((height, width), dtype=torch.int32, device=dev),
        match_u=z,
        match_v=z,
        T_world_ref=se3.identity(dev),
        scene=SceneParams.create(0.0, 1.0, RemodeConfig(), device=dev),
    )


def _leaves(state: SeedState) -> list[torch.Tensor]:
    return ([getattr(state, f.name) for f in dataclasses.fields(SeedState) if f.name != "scene"]
            + [getattr(state.scene, f.name) for f in dataclasses.fields(SceneParams)])


def state_bytes(state: SeedState) -> int:
    """Bytes of the state's tensors."""
    return sum(t.numel() * t.element_size() for t in _leaves(state))


def copy_into(dst: SeedState, src: SeedState) -> None:
    """Write ``src`` into the buffers of ``dst`` (same shapes and dtypes), in
    stream order; a leaf that already is its buffer is skipped."""
    for d, s in zip(_leaves(dst), _leaves(src)):
        if s is not d:
            d.copy_(s)


def clone_scene(scene: SceneParams) -> SceneParams:
    """A copy of ``scene`` in fresh device memory."""
    return SceneParams(**{f.name: getattr(scene, f.name).clone()
                          for f in dataclasses.fields(SceneParams)})


def clone(state: SeedState) -> SeedState:
    """A copy of ``state`` in fresh device memory, which nothing that
    writes ``state`` later changes."""
    return SeedState(scene=clone_scene(state.scene), **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(SeedState) if f.name != "scene"})


def state_from_numpy(arrays: dict, device=None) -> SeedState:
    """Build a state from numpy arrays keyed by field name, ``scene`` a
    nested dict keyed by SceneParams field (the leaves of a JAX
    ``SeedState``)."""
    def t(x):
        return torch.tensor(np.asarray(x), device=device)

    scene = SceneParams(
        **{f.name: t(arrays["scene"][f.name]).float()
           for f in dataclasses.fields(SceneParams)}
    )
    leaves = {}
    for f in dataclasses.fields(SeedState):
        if f.name == "scene":
            continue
        x = t(arrays[f.name])
        leaves[f.name] = x.int() if f.name == "conv" else x.float()
    return SeedState(scene=scene, **leaves)


def states_from_numpy(arrays: dict, device=None) -> list[SeedState]:
    """The slots of a JAX keyframe ring: ``arrays`` as ``state_from_numpy``
    takes them, every leaf with a leading ``[B]`` axis (a JAX
    ``BatchedDepthmap.states``). Returns ``B`` states."""
    n = len(arrays["mu"])
    return [
        state_from_numpy(
            {k: (v[b] if k != "scene" else {s: x[b] for s, x in v.items()})
             for k, v in arrays.items()},
            device=device,
        )
        for b in range(n)
    ]


def stack_states(states: list[SeedState]) -> SeedState:
    """One ``SeedState`` whose every leaf stacks the slots' along a leading
    ``[B]`` axis (a copy, for inspection)."""
    def stack(get):
        return torch.stack([get(s) for s in states])

    scene = SceneParams(**{f.name: stack(lambda s, n=f.name: getattr(s.scene, n))
                           for f in dataclasses.fields(SceneParams)})
    return SeedState(scene=scene, **{
        f.name: stack(lambda s, n=f.name: getattr(s, n))
        for f in dataclasses.fields(SeedState) if f.name != "scene"})


def state_to_numpy(state: SeedState) -> dict:
    """Inverse of ``state_from_numpy``."""
    out = {
        f.name: getattr(state, f.name).cpu().numpy()
        for f in dataclasses.fields(SeedState) if f.name != "scene"
    }
    out["scene"] = {
        f.name: getattr(state.scene, f.name).cpu().numpy()
        for f in dataclasses.fields(SceneParams)
    }
    return out
