"""SE(3) rigid transforms as ``(3, 4)`` float32 tensors ``[R | t]``.

Counterpart of ``rpg_open_remode_tpu/utils/se3.py`` (the reference's
``SE3<float>``, ``include/rmd/se3.cuh:27-168``). Dataset poses are
``T_world_curr``; the engine consumes ``T_curr_world`` and stores
``T_world_ref = inv(T_curr_world)``.
"""

from __future__ import annotations

import torch


def from_quat_t(qw, qx, qy, qz, tx, ty, tz, device=None) -> torch.Tensor:
    """Build ``[R | t]`` from a normalized quaternion and translation (the
    reference ctor's expansion, se3.cuh:38-66)."""
    qw, qx, qy, qz, tx, ty, tz = (
        torch.tensor(float(v), dtype=torch.float32, device=device)
        for v in (qw, qx, qy, qz, tx, ty, tz)
    )
    x, y, z = 2 * qx, 2 * qy, 2 * qz
    wx, wy, wz = x * qw, y * qw, z * qw
    xx, xy, xz = x * qx, y * qx, z * qx
    yy, yz, zz = y * qy, z * qy, z * qz
    return torch.stack([
        torch.stack([1 - (yy + zz), xy - wz, xz + wy, tx]),
        torch.stack([xy + wz, 1 - (xx + zz), yz - wx, ty]),
        torch.stack([xz - wy, yz + wx, 1 - (xx + yy), tz]),
    ])


def identity(device=None) -> torch.Tensor:
    return torch.cat(
        [torch.eye(3, device=device), torch.zeros((3, 1), device=device)], dim=1
    )


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[:, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[:, 3]


def inv(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform: ``[R^T | -R^T t]`` (se3.cuh:79-96)."""
    Rt = rotation(T).T
    return torch.cat([Rt, (-Rt @ translation(T))[:, None]], dim=1)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A * B`` (se3.cuh:146-162)."""
    Ra, ta = rotation(A), translation(A)
    Rb, tb = rotation(B), translation(B)
    return torch.cat([Ra @ Rb, (Ra @ tb + ta)[:, None]], dim=1)


def rotate(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate points ``p`` with shape ``(..., 3)`` by R."""
    return p @ rotation(T).T


def apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Full action ``R p + t`` on points with shape ``(..., 3)``."""
    return p @ rotation(T).T + translation(T)
