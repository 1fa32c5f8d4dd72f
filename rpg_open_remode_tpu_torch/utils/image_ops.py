"""Image-space helper ops (counterpart of
``rpg_open_remode_tpu/utils/image_ops.py``): the Scharr gradient of the
reference's test kernels (test/sobel.cu:24-120), its magnitude, and 2x2
pyramids. Functions of ``[H, W]`` tensors on any device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_SMOOTH = (3.0, 10.0, 3.0)
_DIFF = (-1.0, 0.0, 1.0)


def _conv_sep(img: torch.Tensor, ky, kx) -> torch.Tensor:
    """Separable 3x3 correlation with edge-replicate padding (the clamp
    addressing of the reference's texture variant, test/sobel.cu:80-120)."""
    p = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    rows = ky[0] * p[:-2, :] + ky[1] * p[1:-1, :] + ky[2] * p[2:, :]
    return kx[0] * rows[:, :-2] + kx[1] * rows[:, 1:-1] + kx[2] * rows[:, 2:]


def scharr_x(img: torch.Tensor) -> torch.Tensor:
    """Scharr x-gradient, OpenCV CV_SCHARR semantics (the oracle of
    test/device_image_test.cpp:158-283)."""
    return _conv_sep(img, _SMOOTH, _DIFF)


def scharr_y(img: torch.Tensor) -> torch.Tensor:
    return _conv_sep(img, _DIFF, _SMOOTH)


def gradient_magnitude(img: torch.Tensor) -> torch.Tensor:
    gx = scharr_x(img)
    gy = scharr_y(img)
    return torch.sqrt(gx * gx + gy * gy)


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 box downsample (a pyramid level)."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    x = img[: 2 * h2, : 2 * w2]
    return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2])


def pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Image pyramid [full, /2, /4, ...]."""
    out = [img]
    for _ in range(levels - 1):
        out.append(downsample2(out[-1]))
    return out
