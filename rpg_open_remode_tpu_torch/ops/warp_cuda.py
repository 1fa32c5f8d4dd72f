"""The two-pass homography warp as one CUDA kernel (``csrc/warp.cu``) and its
plain PyTorch version.

Counterpart of ``rpg_open_remode_tpu/utils/warp.homography_warp`` with its
Pallas resamplers (``rpg_open_remode_tpu/ops/warp_pallas.py``:
``_resample0_kernel``, ``_resample1_kernel``). The plain version is the
two-pass composition of ``utils/warp.py``: the coordinate fields
(``two_pass_coords``), then ``resample_cuda.resample_rows_plain`` and
``resample_cols_plain``. The kernel computes the same fields in registers
and writes only the warped image (and u, v when asked). Both take a batch of
homographies ``H [P, 3, 3]`` over one source stack. On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from rpg_open_remode_tpu_torch import kernels
from rpg_open_remode_tpu_torch.ops.resample_cuda import resample_cols_plain, resample_rows_plain

_EPS = 1e-8
MAX_BATCH = 65535   # the grid's z extent


def safe(den: torch.Tensor) -> torch.Tensor:
    """``den`` with magnitudes below 1e-8 replaced by +-1e-8 (its sign;
    +1e-8 at zero)."""
    return torch.where(
        torch.abs(den) < _EPS,
        torch.where(den >= 0, torch.full_like(den, _EPS), torch.full_like(den, -_EPS)),
        den,
    )


def two_pass_coords(H: torch.Tensor, ws: int, out_h: int, out_w: int, x0=0.0, y0=0.0):
    """The coordinate fields of the two-pass warp under each float32
    homography of ``H [P, 3, 3]`` (output pixel -> source pixel), output
    grid ``x in [x0, x0 + out_w)``, ``y in [y0, y0 + out_h)``: ``q [P, Ho,
    Ws]``, the source row at which pass 1 samples source column X for output
    row yo, and ``u, v [P, Ho, Wo]``, each output pixel's source
    coordinates."""
    dev = H.device
    a, b, c, d, e, f, g, h, i = H.reshape(-1, 9, 1, 1).unbind(1)   # each [P, 1, 1]
    yo = y0 + torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(ws, dtype=torch.float32, device=dev)[None, :]
    # pass 1: for source column X and output row yo, sample row
    # q(X, yo) = v(x~, yo) where u(x~, yo) = X:
    #   x~ = (X (h yo + i) - b yo - c) / (a - X g)
    hy_i = h * yo + i
    x_t = (xs * hy_i - b * yo - c) / safe(a - xs * g)
    q = (d * x_t + e * yo + f) / safe(g * x_t + hy_i)
    xo = x0 + torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    den = safe(g * xo + h * yo + i)
    u = (a * xo + b * yo + c) / den
    v = (d * xo + e * yo + f) / den
    return q, u, v


def homography_warp_plain(img: torch.Tensor, H: torch.Tensor, out_h: int, out_w: int,
                          x0=0.0, y0=0.0):
    """Warp ``img [C, Hs, Ws]`` by each homography of ``H [P, 3, 3]``:
    ``(out [P, C, Ho, Wo], u, v [P, Ho, Wo])``. Out-of-image samples are
    clamp-extended."""
    q, u, v = two_pass_coords(H.to(torch.float32), img.shape[-1], out_h, out_w, x0, y0)
    out = torch.stack([resample_cols_plain(resample_rows_plain(img, q[p]), u[p])
                       for p in range(q.shape[0])])
    return out, u, v


def homography_warp(img: torch.Tensor, H: torch.Tensor, out_h: int, out_w: int, x0=0.0,
                    y0=0.0, want_uv: bool = True):
    """The kernel on CUDA tensors, the plain version on CPU tensors: ``(out
    [P, C, Ho, Wo], u, v [P, Ho, Wo])``, with ``u`` and ``v`` None unless
    ``want_uv``. ``img`` is ``[C, Hs, Ws]`` and ``H`` ``[P, 3, 3]``, both
    float32 and contiguous on the card."""
    if img.dim() != 3 or H.dim() != 3 or tuple(H.shape[1:]) != (3, 3):
        raise ValueError(f"expected img [C, Hs, Ws] and H [P, 3, 3], got {tuple(img.shape)} "
                         f"and {tuple(H.shape)}")
    c, hs, ws = img.shape
    p = H.shape[0]
    if min(c, hs, ws, out_h, out_w, p) <= 0 or p > MAX_BATCH:
        raise ValueError(f"empty or oversized warp: C {c}, source {hs}x{ws}, output "
                         f"{out_h}x{out_w}, {p} homographies (at most {MAX_BATCH})")
    if not img.is_cuda:
        out, u, v = homography_warp_plain(img, H, out_h, out_w, x0, y0)
        return (out, u, v) if want_uv else (out, None, None)
    kernels.require(img, "img")
    kernels.require(H, "H", (p, 3, 3))
    if H.device != img.device:
        raise ValueError(f"H on {H.device}, img on {img.device}")
    out = torch.empty((p, c, out_h, out_w), dtype=torch.float32, device=img.device)
    u = v = None
    if want_uv:
        u = torch.empty((p, out_h, out_w), dtype=torch.float32, device=img.device)
        v = torch.empty_like(u)
    err = kernels.library().remode_homography_warp(
        img.data_ptr(), H.data_ptr(), out.data_ptr(), None if u is None else u.data_ptr(),
        None if v is None else v.data_ptr(), c, hs, ws, out_h, out_w, p, float(x0), float(y0),
        int(want_uv), kernels.stream_of(img),
    )
    kernels.check(err, "homography_warp")
    kernels.count("warp")
    return out, u, v
