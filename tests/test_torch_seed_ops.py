"""Seed operations and the denoiser of the port against the JAX package on
the same numpy inputs (rtol 1e-5, atol 1e-6; conv maps exact)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpg_open_remode_tpu import config as jcfg
from rpg_open_remode_tpu.models import state as jstate
from rpg_open_remode_tpu.ops import denoise as jdenoise
from rpg_open_remode_tpu.ops import denoise_pallas as jdenoise_pallas
from rpg_open_remode_tpu.ops import reduction as jreduction
from rpg_open_remode_tpu.ops import seed_check as jseed_check
from rpg_open_remode_tpu.ops import seed_init as jseed_init
from rpg_open_remode_tpu.ops import seed_update as jseed_update
from rpg_open_remode_tpu.ops import triangulation as jtri
from rpg_open_remode_tpu.utils import camera as jcamera
from rpg_open_remode_tpu.utils import se3 as jse3
from rpg_open_remode_tpu_torch import config as pcfg
from rpg_open_remode_tpu_torch.models import state as pstate
from rpg_open_remode_tpu_torch.ops import denoise as pdenoise
from rpg_open_remode_tpu_torch.ops import reduction as preduction
from rpg_open_remode_tpu_torch.ops import seed_check as pseed_check
from rpg_open_remode_tpu_torch.ops import seed_init as pseed_init
from rpg_open_remode_tpu_torch.ops import seed_update as pseed_update
from rpg_open_remode_tpu_torch.ops import triangulation as ptri
from rpg_open_remode_tpu_torch.utils import camera as pcamera
from torch_parity import jax_state_numpy

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)
CAM = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)
H, W = 40, 48


def close(p, j, **kw):
    np.testing.assert_allclose(np.asarray(p), np.asarray(j), **(kw or TOL))


def T(x):
    return torch.tensor(np.asarray(x))


def J(x):
    return jnp.asarray(np.asarray(x))


def _random_seeds(rng):
    return dict(
        mu=rng.uniform(1.0, 2.5, (H, W)).astype(np.float32),
        sigma_sq=rng.uniform(0.01, 0.05, (H, W)).astype(np.float32),
        a=rng.uniform(1.5, 30, (H, W)).astype(np.float32),
        b=rng.uniform(1.5, 30, (H, W)).astype(np.float32),
    )


def _pair_state(rng):
    """One mid-keyframe state in both packages (the JAX one built by its own
    seed_init, carried across with state_from_numpy)."""
    cfg = jcfg.RemodeConfig()
    img = rng.random((H, W), dtype=np.float32)
    scene = jstate.SceneParams.create(0.8, 2.9, cfg)
    st = jseed_init.init_seeds(
        jstate.empty_state(H, W, jcamera.PinholeCamera.create(**CAM)),
        J(img), jse3.identity(), scene, cfg,
    )
    st = dataclasses.replace(st, **{k: J(v) for k, v in _random_seeds(rng).items()})
    return st, pstate.state_from_numpy(jax_state_numpy(st))


@pytest.mark.parametrize("side", [5, 9])
def test_seed_init_matches_jax(side):
    rng = np.random.default_rng(10)
    img = rng.random((H, W), dtype=np.float32)
    img[10:20, 10:20] = 0.4  # a flat patch: the cancellation case
    cj = jcfg.RemodeConfig(patch_side=side)
    cp = pcfg.RemodeConfig(patch_side=side)
    for a, b in zip(pseed_init.template_stats(T(img), cp),
                    jseed_init.template_stats(J(img), cj)):
        close(a, b, rtol=1e-5, atol=1e-4)
    js = jstate.SceneParams.create(0.8, 2.9, cj)
    ps = pstate.SceneParams.create(0.8, 2.9, cp)
    Tw = np.asarray(jse3.identity())
    jst = jseed_init.init_seeds(
        jstate.empty_state(H, W, jcamera.PinholeCamera.create(**CAM)), J(img), J(Tw), js, cj)
    pst = pseed_init.init_seeds(
        pstate.empty_state(H, W, pcamera.PinholeCamera.create(**CAM)), T(img), T(Tw), ps, cp)
    for name in ("mu", "sigma_sq", "a", "b", "match_u", "match_v"):
        close(getattr(pst, name), getattr(jst, name))
    np.testing.assert_array_equal(np.asarray(pst.conv), np.asarray(jst.conv))


def test_seed_check_matches_jax():
    rng = np.random.default_rng(11)
    s = _random_seeds(rng)
    s["sigma_sq"][::3] = 1e-4  # some converge
    cj, cp = jcfg.RemodeConfig(), pcfg.RemodeConfig()
    want = jseed_check.classify_seeds(
        J(s["mu"]), J(s["sigma_sq"]), J(s["a"]), J(s["b"]), jnp.float32(2e-3),
        jseed_check.border_mask(H, W, cj), cj)
    got = pseed_check.classify_seeds(
        T(s["mu"]), T(s["sigma_sq"]), T(s["a"]), T(s["b"]), torch.tensor(2e-3),
        pseed_check.border_mask(H, W, cp), cp)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert got.dtype == torch.int32
    assert len(np.unique(np.asarray(got))) == 4


def test_triangulation_matches_jax():
    rng = np.random.default_rng(12)
    f_ref = rng.normal(size=(H, W, 3)) * 0.2 + [0, 0, 1]
    f_ref = (f_ref / np.linalg.norm(f_ref, axis=-1, keepdims=True)).astype(np.float32)
    # a wide baseline: the midpoint of near-parallel rays is ill-conditioned
    # (~1/sin^2 of the ray angle), and both packages' float32 rounding is
    # then amplified alike
    Trc = np.asarray(jse3.from_quat_t(0.9995, 0.01, -0.02, 0.01, 0.6, 0.1, -0.05))
    # the current bearings of points at depth 1..3, with a little noise
    pts = f_ref * rng.uniform(1, 3, (H, W, 1))
    f_cur = (pts - Trc[:, 3]) @ Trc[:, :3] + rng.normal(size=f_ref.shape) * 1e-4
    f_cur = (f_cur / np.linalg.norm(f_cur, axis=-1, keepdims=True)).astype(np.float32)
    close(ptri.triangulate_midpoint(T(f_ref), T(f_cur), T(Trc)),
          jtri.triangulate_midpoint(J(f_ref), J(f_cur), J(Trc)))
    z = rng.uniform(1, 3, (H, W)).astype(np.float32)
    # rtol 1e-4: arccos near +-1 amplifies the float32 rounding of its
    # argument (both packages' results are that far from float64)
    close(ptri.triangulation_uncertainty(T(z), T(f_ref), T(Trc[:, 3]), torch.tensor(0.004)),
          jtri.triangulation_uncertainty(J(z), J(f_ref), J(Trc[:, 3]), jnp.float32(0.004)),
          rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("pose_noise", [(0.0, 0.0), (0.1, 0.002)])
def test_seed_update_matches_jax(pose_noise):
    rng = np.random.default_rng(13)
    jst, pst = _pair_state(rng)
    kw = dict(pose_noise_rot_deg=pose_noise[0], pose_noise_trans_m=pose_noise[1])
    cj, cp = jcfg.RemodeConfig(**kw), pcfg.RemodeConfig(**kw)
    conv = rng.choice([0, 1, 3, 4], size=(H, W)).astype(np.int32)
    mu = np.asarray(jst.mu)
    # matches near the reprojection of mu under a lateral baseline, a few
    # sigma away at most (far outliers put the Gaussian's exponent in the
    # hundreds, where any float difference is amplified by that factor)
    Tcr = np.asarray(jse3.from_quat_t(1.0, 0.0, 0.0, 0.0, -0.5, 0.05, 0.0))
    f = np.asarray(jst.f_ref).transpose(1, 2, 0) * mu[..., None]
    pc = f @ Tcr[:, :3].T + Tcr[:, 3]
    mu_u = CAM["fx"] * pc[..., 0] / pc[..., 2] + CAM["cx"] + rng.normal(0, 0.1, (H, W))
    mu_v = CAM["fy"] * pc[..., 1] / pc[..., 2] + CAM["cy"] + rng.normal(0, 0.1, (H, W))
    mu_u, mu_v = mu_u.astype(np.float32), mu_v.astype(np.float32)
    Trc = np.asarray(jse3.inv(J(Tcr)))
    want = jseed_update.update_seeds(
        jst, J(conv), J(mu_u), J(mu_v), J(Trc), jcamera.PinholeCamera.create(**CAM), cj)
    got = pseed_update.update_seeds(
        pst, T(conv), T(mu_u), T(mu_v), T(Trc), pcamera.PinholeCamera.create(**CAM), cp)
    for name in ("mu", "match_u", "match_v"):
        close(getattr(got, name), getattr(want, name))
    # rtol 1e-4: the Beta moment match a' = (e - f) / (f - e / f) cancels
    # (f and e/f agree to ~2 digits at these a, b)
    for name in ("a", "b"):
        close(getattr(got, name), getattr(want, name), rtol=1e-4, atol=1e-6)
    # the posterior variance is a difference of second moments ~mu^2, so
    # its rounding error scales with mu^2, not with sigma_sq: 8 ulp of it
    atol = 8 * np.spacing(np.float32(mu.max() ** 2))
    close(got.sigma_sq, want.sigma_sq, rtol=1e-5, atol=atol)
    np.testing.assert_array_equal(np.asarray(got.conv), np.asarray(want.conv))


def test_reduction_matches_jax():
    rng = np.random.default_rng(14)
    conv = rng.integers(0, 5, (H, W)).astype(np.int32)
    want = jreduction.convergence_stats(J(conv))
    got = preduction.convergence_stats(T(conv))
    assert {k: int(v) for k, v in got.items()} == {k: int(v) for k, v in want.items()}
    img = rng.random((H, W), dtype=np.float32)
    close(preduction.image_sum(T(img)), jreduction.image_sum(J(img)))


def _denoise_inputs(seed, h, w):
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(1.0, 2.0, (h, w)).astype(np.float32),
        rng.uniform(5, 20, (h, w)).astype(np.float32),
        rng.uniform(5, 20, (h, w)).astype(np.float32),
        rng.uniform(0.001, 0.05, (h, w)).astype(np.float32),
    )


def test_denoise_matches_jax_loop():
    mu, a, b, sig = _denoise_inputs(23, 24, 32)
    cj = jcfg.RemodeConfig(use_pallas=False)
    want = jdenoise.denoise(J(mu), J(a), J(b), J(sig), jnp.float32(1.7), cj,
                            lam=0.5, iterations=20)
    got = pdenoise.denoise(T(mu), T(a), T(b), T(sig), torch.tensor(1.7),
                           pcfg.RemodeConfig(), lam=0.5, iterations=20)
    close(got, want)


def test_denoise_matches_jax_tiled_pallas():
    """Against the banded Pallas kernel (interpret mode) at a height that is
    not a band multiple, with a remainder chunk (37 = 16 + 16 + 5)."""
    mu, a, b, sig = _denoise_inputs(29, 150, 256)
    cj = jcfg.RemodeConfig()
    g = jdenoise.compute_weights(J(a), J(b), J(sig), 1.7 * 1.7 * cj.large_sigma_sq_factor)
    want = jdenoise_pallas.tvl1_pallas_tiled(J(mu), g, jnp.float32(0.5), 37, cj,
                                             chunk_iters=16)
    got = pdenoise.denoise(T(mu), T(a), T(b), T(sig), torch.tensor(1.7),
                           pcfg.RemodeConfig(), lam=0.5, iterations=37)
    close(got, want)
