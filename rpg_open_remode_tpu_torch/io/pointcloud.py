"""Point-cloud assembly and export (counterpart of
``rpg_open_remode_tpu/io/pointcloud.py``; the reference Publisher,
src/publisher.cpp:54-136).

The back-projection ``p = T_world_ref * (f_hat * depth)`` of every pixel is
one device expression; the CONVERGED pixels' points and intensities then
come to the host in one download. Export is binary PLY (the native writer)
or NPZ. ``voxel_downsample`` and ``GlobalMap`` fuse keyframes on the host in
numpy, as the JAX module does; ``convergence_overlay`` tints the reference
image blue where CONVERGED and red where DIVERGED.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from rpg_open_remode_tpu_torch import native
from rpg_open_remode_tpu_torch.config import ConvergenceState
from rpg_open_remode_tpu_torch.models.state import SeedState


def _backproject(f_ref: torch.Tensor, depth: torch.Tensor, T_world_ref: torch.Tensor):
    """World-frame points of all pixels, ``[3, H, W]``: T_world_ref @ (f_hat
    * depth) (publisher.cpp:73-76), the rotation as explicit products."""
    p = f_ref * depth[None]
    R, t = T_world_ref[:, :3], T_world_ref[:, 3]
    return torch.stack([R[i, 0] * p[0] + R[i, 1] * p[1] + R[i, 2] * p[2] + t[i]
                        for i in range(3)])


def backproject_converged(state: SeedState, depth=None) -> tuple[np.ndarray, np.ndarray]:
    """(xyz [N, 3], intensity [N]) of all CONVERGED seeds in the world frame.

    ``depth`` defaults to the posterior mean; pass the denoised map for
    smoothed clouds (the reference publishes the denoised map,
    depthmap_node.cpp:167-170)."""
    dev = state.mu.device
    d = state.mu if depth is None else torch.as_tensor(np.asarray(depth, np.float32)).to(dev)
    pts = _backproject(state.f_ref, d, state.T_world_ref)
    mask = state.conv == int(ConvergenceState.CONVERGED)
    rows = torch.cat([pts[:, mask].T, state.ref_img[mask][:, None]], dim=1).cpu().numpy()
    return np.ascontiguousarray(rows[:, :3]), np.ascontiguousarray(rows[:, 3])


def save_pointcloud_ply(path: str, state: SeedState, depth=None) -> int:
    """Export the converged-seed cloud as binary PLY. Returns the count."""
    xyz, intensity = backproject_converged(state, depth)
    native.write_ply(path, xyz, intensity)
    return xyz.shape[0]


def save_pointcloud_npz(path: str, state: SeedState, depth=None) -> int:
    xyz, intensity = backproject_converged(state, depth)
    np.savez_compressed(path, xyz=xyz, intensity=intensity)
    return xyz.shape[0]


def voxel_downsample(xyz: np.ndarray, intensity: np.ndarray, voxel: float,
                     weights: np.ndarray | None = None):
    """Mean position/intensity per occupied voxel of edge length ``voxel``
    (metres); order-independent sums over voxel bins.

    Without ``weights``: ``(xyz, intensity)`` of plain per-voxel means. With
    ``weights`` (one per input point): ``(xyz, intensity, weight)``, weighted
    means and each voxel's summed weight, so incremental fusion keeps exact
    running means."""
    if xyz.shape[0] == 0:
        if weights is None:
            return xyz, intensity
        return xyz, intensity, np.zeros((0,), np.float64)
    w = np.ones(xyz.shape[0], np.float64) if weights is None else weights
    keys = np.floor(xyz / voxel).astype(np.int64)
    keys -= keys.min(axis=0)
    dims = keys.max(axis=0) + 1
    flat = (keys[:, 0] * dims[1] + keys[:, 1]) * dims[2] + keys[:, 2]
    uniq, inv = np.unique(flat, return_inverse=True)
    wsum = np.bincount(inv, weights=w)
    out = np.empty((uniq.shape[0], 3), np.float32)
    for i in range(3):
        out[:, i] = np.bincount(inv, weights=w * xyz[:, i]) / wsum
    inten = (np.bincount(inv, weights=w * intensity) / wsum).astype(np.float32)
    if weights is None:
        return out, inten
    return out, inten, wsum


class GlobalMap:
    """World-frame map fused across keyframes: every finalized keyframe's
    converged seeds (with the denoised depth) are fused into a voxel grid,
    so overlapping keyframes merge instead of duplicating. Thread-safe:
    ``add_keyframe`` is meant as a ``DepthmapNode`` ``on_keyframe``
    consumer, which runs on the node's worker thread."""

    def __init__(self, voxel: float = 0.01):
        self.voxel = float(voxel)
        self._lock = threading.Lock()
        self._xyz = np.zeros((0, 3), np.float32)
        self._intensity = np.zeros((0,), np.float32)
        self._weight = np.zeros((0,), np.float64)   # points fused per voxel
        self.n_keyframes = 0

    def add_keyframe(self, result) -> None:
        """Fuse a finalized keyframe (``models.node.KeyframeResult`` or any
        object with ``.state`` and ``.denoised_depth``)."""
        self.add_points(*backproject_converged(result.state, result.denoised_depth))

    def add_points(self, xyz: np.ndarray, inten: np.ndarray) -> None:
        """Fuse one keyframe's back-projected points, as
        ``backproject_converged`` returns them."""
        with self._lock:
            self._xyz, self._intensity, self._weight = voxel_downsample(
                np.concatenate([self._xyz, xyz]),
                np.concatenate([self._intensity, inten]),
                self.voxel,
                weights=np.concatenate([self._weight, np.ones(xyz.shape[0], np.float64)]),
            )
            self.n_keyframes += 1

    def cloud(self) -> tuple[np.ndarray, np.ndarray]:
        with self._lock:
            return self._xyz.copy(), self._intensity.copy()

    def save_ply(self, path: str) -> int:
        xyz, inten = self.cloud()
        native.write_ply(path, xyz, inten)
        return xyz.shape[0]

    def save_npz(self, path: str) -> int:
        xyz, inten = self.cloud()
        np.savez_compressed(path, xyz=xyz, intensity=inten)
        return xyz.shape[0]


def convergence_overlay(state: SeedState) -> np.ndarray:
    """RGB uint8 [H, W, 3]: the reference image tinted blue where CONVERGED
    and red where DIVERGED (publisher.cpp:119-136)."""
    gray = np.clip(state.ref_img.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
    rgb = np.stack([gray, gray, gray], axis=-1)
    conv = state.conv.cpu().numpy()
    rgb[conv == int(ConvergenceState.CONVERGED)] = [0, 0, 255]
    rgb[conv == int(ConvergenceState.DIVERGED)] = [255, 0, 0]
    return rgb
