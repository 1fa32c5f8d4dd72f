"""The port's resampling passes and two-pass homography warp against the
JAX package (its exact XLA tent resamplers, and once its banded Pallas
resamplers in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpg_open_remode_tpu.utils import warp as jwarp
from rpg_open_remode_tpu_torch.ops import resample_cuda
from rpg_open_remode_tpu_torch.utils import warp as pwarp

torch.set_num_threads(2)


def _smooth_stack(c, h, w, seed=0):
    """C smooth images in [0, 1]."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.zeros((c, h, w), np.float32)
    for k in range(c):
        for _ in range(12):
            cy, cx = rng.rand() * h, rng.rand() * w
            s = 6 + 16 * rng.rand()
            out[k] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        out[k] /= out[k].max()
    return out


def _rect_like_H(theta=0.02, tx=5.0, ty=-3.0, scale=1.01):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[scale * c, -s, tx], [s, scale * c, ty], [2e-6, -1e-6, 1.0]],
                    np.float32)


def test_resample_passes_match_jax():
    rng = np.random.default_rng(3)
    img = _smooth_stack(3, 40, 56, 1)
    q = rng.uniform(-2, 42, (36, 56)).astype(np.float32)     # out of range clamps
    u = rng.uniform(-2, 58, (40, 70)).astype(np.float32)     # output wider than source
    got = pwarp.resample_rows(torch.tensor(img), torch.tensor(q))
    want = jwarp.resample_rows(jnp.asarray(img), jnp.asarray(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    got = pwarp.resample_cols(torch.tensor(img), torch.tensor(u))
    want = jwarp.resample_cols(jnp.asarray(img), jnp.asarray(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # exact-integer positions and the last row/column select the source
    qi = np.tile(np.arange(40, dtype=np.float32)[:, None], (1, 56))
    np.testing.assert_array_equal(
        resample_cuda.resample_rows_plain(torch.tensor(img), torch.tensor(qi)).numpy(), img)


@pytest.mark.parametrize("channels,x0", [(1, 0.0), (3, 0.0), (5, 0.0), (1, -16.0)])
def test_homography_warp_matches_jax_xla(channels, x0):
    hs, ws, ho = 64, 96, 72
    wo = 96 if x0 == 0.0 else 96 + 32   # the current-frame warp: rect_w + 2 pad
    img = _smooth_stack(channels, hs, ws, channels)
    img = img[0] if channels == 1 else img
    H = _rect_like_H(theta=0.03, tx=6.0, ty=-4.0, scale=1.02)
    got, gu, gv = pwarp.homography_warp(torch.tensor(img), torch.tensor(H), ho, wo, x0=x0)
    want, ju, jv = jwarp.homography_warp(jnp.asarray(img), jnp.asarray(H), ho, wo,
                                         x0=x0, impl="xla")
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gu.numpy(), np.asarray(ju), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(gv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-4)


def test_homography_warp_matches_jax_pallas_interpret():
    """Against the banded Pallas resamplers (interpret mode), where the
    sample lands inside the source (as tests/test_warp.py compares them)."""
    hs, ws, ho, wo = 64, 256, 64, 256
    img = _smooth_stack(1, hs, ws, 7)
    H = _rect_like_H(theta=0.03, tx=12.0, ty=-6.0, scale=1.02)
    got, u, v = pwarp.homography_warp(torch.tensor(img), torch.tensor(H), ho, wo, x0=-8.0)
    want, _, _ = jwarp.homography_warp(jnp.asarray(img), jnp.asarray(H), ho, wo, x0=-8.0,
                                       impl="pallas")
    u, v = u.expand(ho, wo).numpy(), v.expand(ho, wo).numpy()
    inside = (u > 2) & (u < ws - 3) & (v > 2) & (v < hs - 3)
    err = np.abs(got.numpy() - np.asarray(want))[:, inside]
    assert err.max() < 1e-3, err.max()


def test_warp_grid_and_intrinsics():
    from rpg_open_remode_tpu.utils import camera as jcam
    from rpg_open_remode_tpu_torch.utils import camera as pcam

    img = _smooth_stack(1, 30, 40, 2)[0]
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:30, 0:40].astype(np.float32)
    u = (xx + rng.uniform(-0.5, 0.5, xx.shape)).astype(np.float32)
    v = (yy + rng.uniform(-0.5, 0.5, yy.shape)).astype(np.float32)
    np.testing.assert_allclose(
        pwarp.warp_grid(torch.tensor(img), torch.tensor(u), torch.tensor(v)).numpy(),
        np.asarray(jwarp.warp_grid(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))),
        atol=1e-5, rtol=0)
    kw = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)
    jc, pc = jcam.PinholeCamera.create(**kw), pcam.PinholeCamera.create(**kw)
    np.testing.assert_allclose(pwarp.intrinsic_inv(pc).numpy(),
                               np.asarray(jwarp.intrinsic_inv(jc)), rtol=1e-6)
    R = np.asarray(_rect_like_H(0.05, 0, 0, 1.0))
    R[2] = [0, 0, 1]
    t = np.array([0.1, 0.02, 0.01], np.float32)
    for a, b in zip(pwarp.infinite_homography(torch.tensor(R), torch.tensor(t), pc),
                    jwarp.infinite_homography(jnp.asarray(R), jnp.asarray(t), jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
    Hs = _rect_like_H()
    np.testing.assert_allclose(
        pwarp.shift_origin(torch.tensor(Hs), -8.0, 24.0).numpy(),
        np.asarray(jwarp.shift_origin(jnp.asarray(Hs), jnp.float32(-8.0), jnp.float32(24.0))),
        rtol=1e-6)
