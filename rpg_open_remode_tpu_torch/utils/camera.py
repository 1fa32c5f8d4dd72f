"""Pinhole camera model (counterpart of ``rpg_open_remode_tpu/utils/camera.py``,
the reference's ``pinhole_camera.cuh:27-63``).

The intrinsics are 0-d float32 tensors on the engine's device, so every
expression rounds as the JAX package's float32 arrays do. Negative focal
lengths are legal (the reference synthetic dataset uses fy = -480).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @classmethod
    def create(cls, fx, fy, cx, cy, device=None) -> "PinholeCamera":
        return cls(
            *(torch.tensor(float(v), dtype=torch.float32, device=device)
              for v in (fx, fy, cx, cy))
        )

    def cam2world(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Unproject pixel coords to a z=1 ray, shape ``(..., 3)``
        (pinhole_camera.cuh:40-46)."""
        x = (u - self.cx) / self.fx
        y = (v - self.cy) / self.fy
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)

    def world2cam(self, xyz: torch.Tensor):
        """Perspective-project points ``(..., 3)`` to pixel coords (u, v)
        (pinhole_camera.cuh:48-54)."""
        u = self.fx * xyz[..., 0] / xyz[..., 2] + self.cx
        v = self.fy * xyz[..., 1] / xyz[..., 2] + self.cy
        return u, v

    def one_pix_angle(self) -> torch.Tensor:
        """Angle subtended by one pixel: 2*atan2(1, 2fx) (pinhole_camera.cuh:56-60)."""
        return torch.atan2(torch.ones_like(self.fx), 2.0 * self.fx) * 2.0

    def bearing_grid(self, height: int, width: int) -> torch.Tensor:
        """Normalized bearing vectors for every pixel, shape ``(3, H, W)``."""
        dev = self.fx.device
        v, u = torch.meshgrid(
            torch.arange(height, dtype=torch.float32, device=dev),
            torch.arange(width, dtype=torch.float32, device=dev),
            indexing="ij",
        )
        f = self.cam2world(u, v)
        f = f / torch.linalg.norm(f, dim=-1, keepdim=True)
        # contiguous: reductions over the channel axis then round the same
        # whether the state was computed here or loaded from a checkpoint
        return torch.movedim(f, -1, 0).contiguous()
