"""Frozen copies of rpg_open_remode_tpu_torch/utils/{se3,camera,interp,warp}.py
and the plain versions of ops/{warp_cuda,resample_cuda}.py: poses, the
pinhole camera, box sums and the two-pass homography warp."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

_EPS = 1e-8


# -- SE(3) as (3, 4) [R | t] -------------------------------------------------

def rotation(T):
    return T[:, :3]


def translation(T):
    return T[:, 3]


def inv(T):
    Rt = rotation(T).T
    return torch.cat([Rt, (-Rt @ translation(T))[:, None]], dim=1)


def compose(A, B):
    Ra, ta = rotation(A), translation(A)
    Rb, tb = rotation(B), translation(B)
    return torch.cat([Ra @ Rb, (Ra @ tb + ta)[:, None]], dim=1)


def rotate(T, p):
    return p @ rotation(T).T


# -- pinhole camera -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @classmethod
    def create(cls, fx, fy, cx, cy, device=None) -> "PinholeCamera":
        return cls(*(torch.tensor(float(v), dtype=torch.float32, device=device)
                     for v in (fx, fy, cx, cy)))

    def cam2world(self, u, v):
        x = (u - self.cx) / self.fx
        y = (v - self.cy) / self.fy
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)

    def one_pix_angle(self):
        return torch.atan2(torch.ones_like(self.fx), 2.0 * self.fx) * 2.0

    def bearing_grid(self, height: int, width: int):
        dev = self.fx.device
        v, u = torch.meshgrid(
            torch.arange(height, dtype=torch.float32, device=dev),
            torch.arange(width, dtype=torch.float32, device=dev),
            indexing="ij",
        )
        f = self.cam2world(u, v)
        f = f / torch.linalg.norm(f, dim=-1, keepdim=True)
        return torch.movedim(f, -1, 0).contiguous()


# -- sampling and box sums ----------------------------------------------------

def bilinear(img, u, v):
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


def window_sum(x, side: int, dim: int):
    n = x.shape[dim] - side + 1
    acc = x.narrow(dim, 0, n)
    for d in range(1, side):
        acc = acc + x.narrow(dim, d, n)
    return acc


def box_sum(img, side: int, offset: int):
    """Clamped (edge-replicated) patch sum anchored at ``offset``."""
    lo = -offset
    hi = side + offset - 1
    padded = F.pad(img[None, None], (lo, hi, lo, hi), mode="replicate")[0, 0]
    return window_sum(window_sum(padded, side, 1), side, 0)


def box_zero(x, side: int):
    """'same' box sum reading zeros outside the grid."""
    hp = side // 2
    p = F.pad(x, (hp, hp, hp, hp))
    return window_sum(window_sum(p, side, -1), side, -2)


# -- the two-pass homography warp ---------------------------------------------

def safe(den):
    return torch.where(
        torch.abs(den) < _EPS,
        torch.where(den >= 0, torch.full_like(den, _EPS), torch.full_like(den, -_EPS)),
        den,
    )


def _taps(q, n: int):
    q = torch.clamp(q, 0.0, n - 1.0)
    j0 = torch.clamp(torch.floor(q), 0.0, max(n - 2, 0))
    f = q - j0
    j0 = j0.long()
    j1 = torch.clamp(j0 + 1, max=n - 1)
    return j0, j1, f


def resample_rows(img, q):
    c = img.shape[0]
    j0, j1, f = _taps(q, img.shape[-2])
    a = torch.gather(img, 1, j0.expand(c, -1, -1))
    b = torch.gather(img, 1, j1.expand(c, -1, -1))
    return (1.0 - f) * a + f * b


def resample_cols(img, u):
    c = img.shape[0]
    i0, i1, f = _taps(u, img.shape[-1])
    a = torch.gather(img, 2, i0.expand(c, -1, -1))
    b = torch.gather(img, 2, i1.expand(c, -1, -1))
    return (1.0 - f) * a + f * b


def two_pass_coords(H, ws: int, out_h: int, out_w: int, x0=0.0, y0=0.0):
    dev = H.device
    a, b, c, d, e, f, g, h, i = H.reshape(-1, 9, 1, 1).unbind(1)
    yo = y0 + torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(ws, dtype=torch.float32, device=dev)[None, :]
    hy_i = h * yo + i
    x_t = (xs * hy_i - b * yo - c) / safe(a - xs * g)
    q = (d * x_t + e * yo + f) / safe(g * x_t + hy_i)
    xo = x0 + torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    den = safe(g * xo + h * yo + i)
    u = (a * xo + b * yo + c) / den
    v = (d * xo + e * yo + f) / den
    return q, u, v


def homography_warp(img, H, out_height: int, out_width: int, x0: float = 0.0,
                    y0: float = 0.0, want_uv: bool = True):
    """Warp ``img [..., Hs, Ws]`` by ``H`` (output pixel -> source pixel):
    ``(warped [..., Ho, Wo], u, v)``, clamp-extended outside the image."""
    stack = img.reshape((-1,) + tuple(img.shape[-2:])).contiguous()
    Hb = H.to(torch.float32).reshape(1, 3, 3).contiguous()
    q, u, v = two_pass_coords(Hb, stack.shape[-1], out_height, out_width, x0, y0)
    out = resample_cols(resample_rows(stack, q[0]), u[0])
    out = out.reshape(tuple(img.shape[:-2]) + (out_height, out_width))
    return out, (u[0] if want_uv else None), (v[0] if want_uv else None)


def homography_coords(H, xo, yo):
    den = safe(H[2, 0] * xo + H[2, 1] * yo + H[2, 2])
    u = (H[0, 0] * xo + H[0, 1] * yo + H[0, 2]) / den
    v = (H[1, 0] * xo + H[1, 1] * yo + H[1, 2]) / den
    return u, v


def _mat3(rows):
    return torch.stack([torch.stack([torch.as_tensor(e) for e in r]) for r in rows])


def intrinsic_matrix(cam):
    z = torch.zeros_like(cam.fx)
    o = torch.ones_like(cam.fx)
    return _mat3([[cam.fx, z, cam.cx], [z, cam.fy, cam.cy], [z, z, o]])


def intrinsic_inv(cam):
    z = torch.zeros_like(cam.fx)
    o = torch.ones_like(cam.fx)
    return _mat3([[1.0 / cam.fx, z, -cam.cx / cam.fx], [z, 1.0 / cam.fy, -cam.cy / cam.fy],
                  [z, z, o]])


def infinite_homography(R, t, cam):
    K = intrinsic_matrix(cam)
    return K @ R @ intrinsic_inv(cam), K @ t
