"""The fused homography warp (``ops/warp_cuda.py``, ``csrc/warp.cu``).

On the CPU: the batched plain version equals, bit for bit, one call per
homography of the unfused two-pass composition (the coordinate fields in
plain PyTorch, then the vertical and the horizontal resampling pass), over
output windows with ``x0 = -pad`` and ``y0 != 0``, C = 1, 3 and 5, ragged
widths and degenerate homographies that reach the near-zero-denominator
guard. On the card (``cuda``-marked, skipped elsewhere): the kernel equals
the plain version bit for bit at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from rpg_open_remode_tpu_torch import kernels
from rpg_open_remode_tpu_torch.ops import resample_cuda, warp_cuda
from rpg_open_remode_tpu_torch.utils import warp as pwarp

torch.set_num_threads(2)
EPS32 = np.float32(1e-8)


def _safe(den):
    return torch.where(
        torch.abs(den) < 1e-8,
        torch.where(den >= 0, torch.full_like(den, 1e-8), torch.full_like(den, -1e-8)),
        den,
    )


def unfused_warp(img, H, out_h, out_w, x0=0.0, y0=0.0):
    """One homography ``H [3, 3]``: the coordinate math written out on 0-d
    elements of H, then the two plain resampling passes."""
    ws = img.shape[-1]
    a, b, c = H[0, 0], H[0, 1], H[0, 2]
    d, e, f = H[1, 0], H[1, 1], H[1, 2]
    g, h, i = H[2, 0], H[2, 1], H[2, 2]
    yo = y0 + torch.arange(out_h, dtype=torch.float32)[:, None]
    xs = torch.arange(ws, dtype=torch.float32)[None, :]
    hy_i = h * yo + i
    x_t = (xs * hy_i - b * yo - c) / _safe(a - xs * g)
    q = (d * x_t + e * yo + f) / _safe(g * x_t + hy_i)
    xo = x0 + torch.arange(out_w, dtype=torch.float32)[None, :]
    den = _safe(g * xo + h * yo + i)
    u = (a * xo + b * yo + c) / den
    v = (d * xo + e * yo + f) / den
    mid = resample_cuda.resample_rows_plain(img, q)
    return resample_cuda.resample_cols_plain(mid, u), u, v


def rect_like(rng, p, tx=5.0, ty=-3.0):
    """P mild rectifying homographies: rotation, scale, shift, perspective."""
    out = []
    for _ in range(p):
        th, s = rng.uniform(-0.05, 0.05), rng.uniform(0.97, 1.03)
        c, n = np.cos(th), np.sin(th)
        out.append([[s * c, -n, tx + rng.uniform(-3, 3)], [n, s * c, ty + rng.uniform(-3, 3)],
                    [rng.uniform(-3e-4, 3e-4), rng.uniform(-3e-4, 3e-4), 1.0]])
    return np.asarray(out, np.float32)


# denominators of exactly 0, of +-1e-10..1e-9 and of -0.0: both signs of
# the guard in u, v (g xo + h yo + i) and in pass 1 (a - X g, g x~ + h yo + i)
DEGENERATE = np.asarray([
    [[1e-10, 0.0, 0.0], [0.0, 1.0, 0.0], [1e-10, 0.0, -5e-10]],
    [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.125, 0.0, -1.0]],
    [[0.0, 1.0, 2.0], [1.0, 0.0, -1.0], [0.0, -0.0, -0.0]],
], np.float32)


def guard_hits(H, ws, out_h, out_w, x0, y0):
    """How many denominators of u, v and of pass 1 fall below 1e-8 in
    magnitude, by sign (>= 0, < 0), in float32 as the warp evaluates them."""
    f32 = np.float32
    a, b, c, d, e, f, g, h, i = (H.reshape(-1, 9)[:, k, None, None] for k in range(9))
    yo = (f32(y0) + np.arange(out_h, dtype=f32))[:, None]
    xo = (f32(x0) + np.arange(out_w, dtype=f32))[None, :]
    xs = np.arange(ws, dtype=f32)[None, :]
    hy_i = h * yo + i
    dens = [g * xo + h * yo + i, a - xs * g]
    x_t = (xs * hy_i - b * yo - c) / np.where(np.abs(dens[1]) < EPS32, EPS32, dens[1])
    dens.append(g * x_t + hy_i)
    small = [x[np.abs(x) < EPS32] for x in dens]
    return sum(int((x >= 0).sum()) for x in small), sum(int((x < 0).sum()) for x in small)


# (C, Hs, Ws, Ho, Wo, x0, y0): the ref stack onto the rect grid, the
# current frame onto the padded window (x0 = -pad), the back-warp, a band
# slab's window (y0 != 0), ragged widths (Wo % 4 != 0)
CASES = {
    "ref stack C=5": (5, 40, 56, 48, 64, 0.0, 0.0),
    "curr C=1 x0=-pad": (1, 40, 56, 48, 64 + 32, -16.0, 0.0),
    "back-warp C=3": (3, 48, 64, 40, 56, 0.0, 0.0),
    "slab C=5 y0=12": (5, 40, 56, 20, 64, 0.0, 12.0),
    "slab C=1 x0=-pad y0=20": (1, 40, 56, 16, 64 + 32, -16.0, 20.0),
    "ragged C=3": (3, 33, 47, 29, 37, 0.0, 0.0),
    "ragged C=1 y0=7": (1, 33, 47, 9, 43, -5.0, 7.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batched_plain_equals_single_unfused_calls(case):
    c, hs, ws, ho, wo, x0, y0 = CASES[case]
    rng = np.random.default_rng(len(case))
    img = torch.tensor(rng.random((c, hs, ws), dtype=np.float32))
    H = torch.tensor(rect_like(rng, 4))
    out, u, v = warp_cuda.homography_warp_plain(img, H, ho, wo, x0, y0)
    assert tuple(out.shape) == (4, c, ho, wo) and tuple(u.shape) == (4, ho, wo)
    for p in range(4):
        want = unfused_warp(img, H[p], ho, wo, x0, y0)
        for got_x, want_x in zip((out[p], u[p], v[p]), want):
            assert torch.equal(got_x, want_x.expand_as(got_x))


@pytest.mark.parametrize("c,x0,y0", [(1, 0.0, 0.0), (3, -4.0, 6.0)])
def test_degenerate_homographies_reach_the_guard(c, x0, y0):
    """Near-zero denominators of both signs, and exact zeros: the batch
    equals the single unfused calls bit for bit (infinities and NaNs where
    the single calls have them)."""
    hs, ws, ho, wo = 24, 30, 20, 26
    assert all(n > 0 for n in guard_hits(DEGENERATE, ws, ho, wo, x0, y0))
    rng = np.random.default_rng(c)
    img = torch.tensor(rng.random((c, hs, ws), dtype=np.float32))
    H = torch.tensor(np.concatenate([DEGENERATE, rect_like(rng, 1)]))
    out, u, v = warp_cuda.homography_warp_plain(img, H, ho, wo, x0, y0)
    for p in range(H.shape[0]):
        want = unfused_warp(img, H[p], ho, wo, x0, y0)
        for got_x, want_x in zip((out[p], u[p], v[p]), want):
            assert torch.equal(got_x.isnan(), want_x.expand_as(got_x).isnan())
            assert torch.equal(torch.nan_to_num(got_x), torch.nan_to_num(want_x).expand_as(got_x))


def test_homography_warp_is_one_batch_of_one():
    """``utils/warp.homography_warp`` (2-D and stacked images, u and v or
    not) gives the unfused composition's values and shapes; on the CPU it
    launches nothing."""
    rng = np.random.default_rng(5)
    H = torch.tensor(rect_like(rng, 1)[0])
    before = dict(kernels.LAUNCHES)
    for shape in ((40, 56), (3, 40, 56)):
        img = torch.tensor(rng.random(shape, dtype=np.float32))
        got, u, v = pwarp.homography_warp(img, H, 48, 96, x0=-16.0, y0=2.0)
        want, wu, wv = unfused_warp(img.reshape(-1, 40, 56), H, 48, 96, -16.0, 2.0)
        assert torch.equal(got, want.reshape(shape[:-2] + (48, 96)))
        assert torch.equal(u, wu) and torch.equal(v, wv)
        img_only, nu, nv = pwarp.homography_warp(img, H, 48, 96, x0=-16.0, y0=2.0,
                                                 want_uv=False)
        assert torch.equal(img_only, got) and nu is None and nv is None
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("img_shape,H_shape", [((8, 8), (1, 3, 3)), ((1, 8, 8), (3, 3)),
                                               ((1, 8, 8), (2, 3, 4)), ((1, 8, 8), (0, 3, 3)),
                                               ((0, 8, 8), (1, 3, 3))])
def test_wrapper_rejects_bad_shapes(img_shape, H_shape):
    """Shapes are checked before the device decides the route, so a CPU
    call refuses what the kernel would."""
    with pytest.raises(ValueError):
        warp_cuda.homography_warp(torch.zeros(img_shape), torch.zeros(H_shape), 4, 4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_wrapper_rejects_bad_tensors(dev):
    img = torch.zeros((1, 8, 8), device=dev)
    H = torch.eye(3, device=dev)[None]
    for bad in (dict(img=img.double()), dict(H=H.double()), dict(H=H.cpu()),
                dict(img=torch.zeros((1, 8, 16), device=dev)[:, :, ::2]),
                dict(H=torch.eye(3, device=dev).t()[None].expand(2, 3, 3))):
        args = {**dict(img=img, H=H), **bad}
        with pytest.raises(ValueError):
            warp_cuda.homography_warp(args["img"], args["H"], 4, 4)


# (C, Hs, Ws, Ho, Wo, x0, y0, P): 640x480's three warps (rect 512x768, pad
# 128), its pure-rotation warp, 752x480's (a ragged last tile), 1920x1080's,
# a band slab and the propagated reseed's chunk of 16 planes, and a width
# that is no multiple of 4
CARD_CASES = [
    (5, 480, 640, 512, 768, 0.0, 0.0, 1), (1, 480, 640, 512, 1024, -128.0, 0.0, 1),
    (3, 512, 768, 480, 640, 0.0, 0.0, 1), (1, 480, 640, 480, 640, 0.0, 0.0, 1),
    (5, 480, 752, 512, 896, 0.0, 0.0, 1), (1, 480, 752, 512, 1152, -128.0, 0.0, 1),
    (3, 512, 896, 480, 752, 0.0, 0.0, 1), (5, 1080, 1920, 1152, 2048, 0.0, 0.0, 1),
    (1, 1080, 1920, 1152, 2816, -384.0, 0.0, 1), (3, 1152, 2048, 1080, 1920, 0.0, 0.0, 1),
    (5, 480, 640, 192, 768, 0.0, 224.0, 1), (3, 480, 640, 480, 640, 0.0, 0.0, 16),
    (3, 97, 131, 89, 123, -3.0, 5.0, 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_warp_kernel_matches_plain(dev, case):
    c, hs, ws, ho, wo, x0, y0, p = case
    rng = np.random.default_rng(ho + p)
    img = torch.tensor(rng.random((c, hs, ws), dtype=np.float32), device=dev)
    H = torch.tensor(np.concatenate([rect_like(rng, p, tx=0.3 * (ws - wo), ty=0.3 * (hs - ho)),
                                     DEGENERATE]), device=dev)
    before = kernels.LAUNCHES["warp"]
    got = warp_cuda.homography_warp(img, H, ho, wo, x0, y0)
    assert kernels.LAUNCHES["warp"] == before + 1
    want = warp_cuda.homography_warp_plain(img, H, ho, wo, x0, y0)
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
    out, u, v = warp_cuda.homography_warp(img, H, ho, wo, x0, y0, want_uv=False)
    assert u is None and v is None and torch.equal(out.nan_to_num(), got[0].nan_to_num())
