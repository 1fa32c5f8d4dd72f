"""The two 1-D resampling passes of the two-pass homography warp: CUDA
kernels (``csrc/resample.cu``) and their plain PyTorch versions.

Counterpart of ``rpg_open_remode_tpu/ops/warp_pallas.py`` (the Pallas
``_resample0_kernel`` / ``_resample1_kernel``) and of the exact XLA tent
resamplers ``rpg_open_remode_tpu/utils/warp.resample_rows/resample_cols``.
The tent-weight sum has at most two non-zero taps, so both versions compute
it as a clamped 2-tap lerp. On a CPU tensor the wrappers run the plain
version; on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from rpg_open_remode_tpu_torch import kernels


def _taps(q: torch.Tensor, n: int):
    """Clamped 2-tap lerp indices and weight of fractional positions ``q``
    into an axis of length ``n``."""
    q = torch.clamp(q, 0.0, n - 1.0)
    j0 = torch.clamp(torch.floor(q), 0.0, max(n - 2, 0))
    f = q - j0
    j0 = j0.long()
    j1 = torch.clamp(j0 + 1, max=n - 1)
    return j0, j1, f


def resample_rows_plain(img: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``out[c, yo, x] = lerp of img[c, :, x] at row q[yo, x]``.
    ``img`` [C, Hs, W], ``q`` [Ho, W] -> [C, Ho, W]."""
    c = img.shape[0]
    j0, j1, f = _taps(q, img.shape[-2])
    a = torch.gather(img, 1, j0.expand(c, -1, -1))
    b = torch.gather(img, 1, j1.expand(c, -1, -1))
    return (1.0 - f) * a + f * b


def resample_cols_plain(img: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``out[c, y, xo] = lerp of img[c, y, :] at column u[y, xo]``.
    ``img`` [C, H, Ws], ``u`` [H, Wo] -> [C, H, Wo]."""
    c = img.shape[0]
    i0, i1, f = _taps(u, img.shape[-1])
    a = torch.gather(img, 2, i0.expand(c, -1, -1))
    b = torch.gather(img, 2, i1.expand(c, -1, -1))
    return (1.0 - f) * a + f * b


def resample_rows(img: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Vertical pass; the kernel on CUDA tensors, the plain version on CPU."""
    if not img.is_cuda:
        return resample_rows_plain(img, q)
    c, hs, w = img.shape
    ho = q.shape[0]
    kernels.require(img, "img")
    kernels.require(q, "q", (ho, w))
    out = torch.empty((c, ho, w), dtype=torch.float32, device=img.device)
    err = kernels.library().remode_resample_rows(
        img.data_ptr(), q.data_ptr(), out.data_ptr(), c, hs, w, ho,
        kernels.stream_of(img),
    )
    kernels.check(err, "resample_rows")
    kernels.count("resample_rows")
    return out


def resample_cols(img: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Horizontal pass; the kernel on CUDA tensors, the plain version on CPU."""
    if not img.is_cuda:
        return resample_cols_plain(img, u)
    c, h, ws = img.shape
    wo = u.shape[1]
    kernels.require(img, "img")
    kernels.require(u, "u", (h, wo))
    out = torch.empty((c, h, wo), dtype=torch.float32, device=img.device)
    err = kernels.library().remode_resample_cols(
        img.data_ptr(), u.data_ptr(), out.data_ptr(), c, h, ws, wo,
        kernels.stream_of(img),
    )
    kernels.check(err, "resample_cols")
    kernels.count("resample_cols")
    return out
