"""Image sampling primitives: bilinear gather and clamped box-filter sums
(counterpart of ``rpg_open_remode_tpu/utils/interp.py``).

``tex2D(tex, x+0.5, y+0.5)`` with bilinear filtering in the reference
(``include/rmd/texture_memory.cuh:27-66``) == ``bilinear(img, x, y)`` here:
everything works in pixel indices, with clamp addressing.

Two border conventions exist in the engine and must not be mixed: the
keyframe template sums here read CLAMPED (edge-replicated) pixels, as the
reference's texture reads do; the rect-grid box sums of the matcher
(``ops/rect_match._box``) read ZEROS outside the grid.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``img[..., H, W]`` at fractional pixel coords
    (u=x, v=y), with clamp addressing (cudaAddressModeClamp)."""
    h, w = img.shape[-2], img.shape[-1]
    u = torch.clamp(u, 0.0, w - 1.0)
    v = torch.clamp(v, 0.0, h - 1.0)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    u0 = u0.long()
    v0 = v0.long()
    u1 = torch.clamp(u0 + 1, max=w - 1)
    v1 = torch.clamp(v0 + 1, max=h - 1)
    i00 = img[..., v0, u0]
    i01 = img[..., v0, u1]
    i10 = img[..., v1, u0]
    i11 = img[..., v1, u1]
    top = i00 + fu * (i01 - i00)
    bot = i10 + fu * (i11 - i10)
    return top + fv * (bot - top)


def window_sum(x: torch.Tensor, side: int, dim: int) -> torch.Tensor:
    """'valid' windowed sum of ``side`` consecutive elements along ``dim``,
    added in window order (as a reduce_window does)."""
    n = x.shape[dim] - side + 1
    acc = x.narrow(dim, 0, n)
    for d in range(1, side):
        acc = acc + x.narrow(dim, d, n)
    return acc


def box_sum(img: torch.Tensor, side: int, offset: int) -> torch.Tensor:
    """Windowed sum over a ``side x side`` patch anchored at ``offset``:
    ``out[y, x] = sum_{dy, dx in [offset, offset+side)} img[clamp(y+dy), clamp(x+dx)]``
    (the clamped-texture patch sum of seed_init.cu:38-52)."""
    lo = -offset
    hi = side + offset - 1
    padded = F.pad(img[None, None], (lo, hi, lo, hi), mode="replicate")[0, 0]
    return window_sum(window_sum(padded, side, 1), side, 0)
