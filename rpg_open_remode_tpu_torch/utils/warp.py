"""Image warps: the exact two-pass homography warp and its helpers
(counterpart of ``rpg_open_remode_tpu/utils/warp.py``).

A projective warp decomposes exactly into two 1-D passes (Catmull & Smith
1980, "3-D transformations of images in scanline order"):

  pass 1 (vertical):   A(x_s, y_o) = img(x_s, q(x_s, y_o))
  pass 2 (horizontal): out(x_o, y_o) = A(u(x_o, y_o), y_o)

where ``(u, v)`` are the source coordinates of output pixel ``(x_o, y_o)``
under H and ``q(X, y) = v(x~, y)`` with ``x~`` solving ``u(x~, y) = X``.
Pass 1 samples each source column at its own row, so the result differs
slightly from a 2-D bilinear sample at (u, v); the engine keeps the
two-pass value. ``homography_warp`` runs coordinates and both passes as one
kernel on the GPU (``ops/warp_cuda.py``, ``csrc/warp.cu``); ``warp_grid``
runs the two 1-D passes ``ops/resample_cuda.resample_rows`` and
``resample_cols`` (CUDA kernels on the GPU).
"""

from __future__ import annotations

import torch

from rpg_open_remode_tpu_torch.ops import resample_cuda, warp_cuda
from rpg_open_remode_tpu_torch.ops.warp_cuda import safe as _safe
from rpg_open_remode_tpu_torch.utils.interp import bilinear


def _as_stack(img: torch.Tensor) -> torch.Tensor:
    return img.reshape((-1,) + tuple(img.shape[-2:])).contiguous()


def resample_rows(img: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample each column of ``img [..., Hs, W]`` at fractional rows
    ``v [Ho, W]`` (clamp addressing; leading axes share the weights)."""
    out = resample_cuda.resample_rows(_as_stack(img), v.contiguous())
    return out.reshape(tuple(img.shape[:-2]) + tuple(out.shape[-2:]))


def resample_cols(img: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Sample each row of ``img [..., H, Ws]`` at fractional columns
    ``u [H, Wo]``."""
    out = resample_cuda.resample_cols(_as_stack(img), u.contiguous())
    return out.reshape(tuple(img.shape[:-2]) + tuple(out.shape[-2:]))


def homography_coords(H: torch.Tensor, xo: torch.Tensor, yo: torch.Tensor):
    """Source coordinates (u, v) of output pixels under 3x3 ``H`` (output
    pixel -> source pixel)."""
    den = _safe(H[2, 0] * xo + H[2, 1] * yo + H[2, 2])
    u = (H[0, 0] * xo + H[0, 1] * yo + H[0, 2]) / den
    v = (H[1, 0] * xo + H[1, 1] * yo + H[1, 2]) / den
    return u, v


def shift_origin(H: torch.Tensor, x0, y0) -> torch.Tensor:
    """``H @ translate(x0, y0)``: the same warp with its output-window origin
    folded into the homography."""
    col2 = x0 * H[:, 0] + y0 * H[:, 1] + H[:, 2]
    return torch.stack([H[:, 0], H[:, 1], col2], dim=1)


def homography_warp(
    img: torch.Tensor,
    H: torch.Tensor,
    out_height: int,
    out_width: int,
    x0: float = 0.0,
    y0: float = 0.0,
    want_uv: bool = True,
):
    """Warp ``img [..., Hs, Ws]`` by homography ``H`` (output pixel -> source
    pixel) onto the grid ``x in [x0, x0+out_width)``, ``y in [y0,
    y0+out_height)``.

    Returns ``(warped [..., Ho, Wo], u, v)`` with (u, v) the source
    coordinates of each output pixel (None unless ``want_uv``, which spares
    the kernel writing them); out-of-image samples are clamp-extended, and
    callers mask with (u, v) where that matters. One
    ``warp_cuda.homography_warp`` call (one kernel launch on the GPU).
    """
    out, u, v = warp_cuda.homography_warp(
        _as_stack(img), H.to(torch.float32).reshape(1, 3, 3).contiguous(), out_height,
        out_width, x0, y0, want_uv,
    )
    out = out[0].reshape(tuple(img.shape[:-2]) + (out_height, out_width))
    return out, (u[0] if want_uv else None), (v[0] if want_uv else None)


def warp_grid(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Resample ``img [H, W]`` at a smooth coordinate grid ``(u, v)`` through
    the two 1-D passes (vertical then horizontal). Approximate for
    non-projective warps (the vertical pass samples at v(x, y) instead of
    v(u(x, y), y)); meant for near-identity lens undistortion remaps."""
    return resample_cols(resample_rows(img, v), u)


def bilinear_gather(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain 4-tap bilinear gather with clamp addressing (test oracle)."""
    return bilinear(img, u, v)


def _mat3(rows) -> torch.Tensor:
    return torch.stack([torch.stack([torch.as_tensor(e) for e in r]) for r in rows])


def intrinsic_matrix(cam) -> torch.Tensor:
    z = torch.zeros_like(cam.fx)
    o = torch.ones_like(cam.fx)
    return _mat3([[cam.fx, z, cam.cx], [z, cam.fy, cam.cy], [z, z, o]])


def intrinsic_inv(cam) -> torch.Tensor:
    z = torch.zeros_like(cam.fx)
    o = torch.ones_like(cam.fx)
    return _mat3(
        [
            [1.0 / cam.fx, z, -cam.cx / cam.fx],
            [z, 1.0 / cam.fy, -cam.cy / cam.fy],
            [z, z, o],
        ]
    )


def infinite_homography(R: torch.Tensor, t: torch.Tensor, cam):
    """(A, e) with A = K R K^-1 (infinite homography) and e = K t (epipole
    direction), for the fronto-parallel plane family H_w = A + w e [0 0 1]."""
    K = intrinsic_matrix(cam)
    A = K @ R @ intrinsic_inv(cam)
    e = K @ t
    return A, e
