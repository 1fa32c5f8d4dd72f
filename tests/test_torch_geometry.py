"""Geometry, sampling, synthetic scenes and state of the port against the
JAX package, on the same numpy inputs (rtol 1e-5, atol 1e-6)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpg_open_remode_tpu import config as jcfg
from rpg_open_remode_tpu.models import state as jstate
from rpg_open_remode_tpu.ops import seed_init as jseed_init
from rpg_open_remode_tpu.utils import camera as jcamera
from rpg_open_remode_tpu.utils import interp as jinterp
from rpg_open_remode_tpu.utils import se3 as jse3
from rpg_open_remode_tpu.utils import synthetic as jsynthetic
from rpg_open_remode_tpu_torch import config as pcfg
from rpg_open_remode_tpu_torch.models import state as pstate
from rpg_open_remode_tpu_torch.utils import camera as pcamera
from rpg_open_remode_tpu_torch.utils import interp as pinterp
from rpg_open_remode_tpu_torch.utils import se3 as pse3
from rpg_open_remode_tpu_torch.utils import synthetic as psynthetic
from torch_parity import jax_state_numpy

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)
CAM = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)


def close(p, j, **kw):
    np.testing.assert_allclose(np.asarray(p), np.asarray(j), **(kw or TOL))


def random_pose(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    t = rng.normal(size=3)
    return np.asarray(jse3.from_quat_t(*q, *t)), (q, t)


def test_se3_matches_jax():
    rng = np.random.default_rng(0)
    A, (q, t) = random_pose(rng)
    B, _ = random_pose(rng)
    close(pse3.from_quat_t(*q, *t), A)
    pts = rng.normal(size=(7, 3)).astype(np.float32)
    tA, tB, tp = torch.tensor(A), torch.tensor(B), torch.tensor(pts)
    jA, jB, jp = jnp.asarray(A), jnp.asarray(B), jnp.asarray(pts)
    close(pse3.inv(tA), jse3.inv(jA))
    close(pse3.compose(tA, tB), jse3.compose(jA, jB))
    close(pse3.rotate(tA, tp), jse3.rotate(jA, jp))
    close(pse3.apply(tA, tp), jse3.apply(jA, jp))
    close(pse3.identity(), jse3.identity())


def test_camera_matches_jax():
    rng = np.random.default_rng(1)
    jc = jcamera.PinholeCamera.create(**CAM)
    pc = pcamera.PinholeCamera.create(**CAM)
    u = rng.uniform(-10, 170, 50).astype(np.float32)
    v = rng.uniform(-10, 130, 50).astype(np.float32)
    close(pc.cam2world(torch.tensor(u), torch.tensor(v)),
          jc.cam2world(jnp.asarray(u), jnp.asarray(v)))
    xyz = rng.normal(size=(50, 3)).astype(np.float32) + [0, 0, 3]
    for a, b in zip(pc.world2cam(torch.tensor(xyz)), jc.world2cam(jnp.asarray(xyz))):
        close(a, b, rtol=1e-5, atol=1e-4)
    close(pc.one_pix_angle(), jc.one_pix_angle())
    close(pc.bearing_grid(12, 16), jc.bearing_grid(12, 16))


@pytest.mark.parametrize("side", [5, 9])
def test_interp_matches_jax(side):
    rng = np.random.default_rng(2)
    img = rng.random((20, 24), dtype=np.float32)
    u = rng.uniform(-3, 27, (9, 11)).astype(np.float32)
    v = rng.uniform(-3, 23, (9, 11)).astype(np.float32)
    close(pinterp.bilinear(torch.tensor(img), torch.tensor(u), torch.tensor(v)),
          jinterp.bilinear(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v)))
    off = -(side // 2)
    close(pinterp.box_sum(torch.tensor(img), side, off),
          jinterp.box_sum(jnp.asarray(img), side, off))


def test_synthetic_bit_identical():
    kw = dict(n_frames=3, width=64, height=48, seed=5, noise_sigma=0.01,
              vignette=0.15, n_textureless=3, n_spheres=2,
              cam=dict(fx=48.1, fy=-48.0, cx=31.5, cy=23.5))
    for motion in ("lateral", "forward", "tumble"):
        a = psynthetic.generate(motion=motion, **kw)
        b = jsynthetic.generate(motion=motion, **kw)
        for fa, fb in zip(a, b):
            for name in ("image", "depth", "T_world_curr"):
                np.testing.assert_array_equal(getattr(fa, name), getattr(fb, name))


def test_state_scene_and_round_trip():
    cfg_j, cfg_p = jcfg.RemodeConfig(), pcfg.RemodeConfig()
    js = jstate.SceneParams.create(0.8, 2.9, cfg_j)
    ps = pstate.SceneParams.create(0.8, 2.9, cfg_p)
    for f in dataclasses.fields(ps):
        close(getattr(ps, f.name), getattr(js, f.name))
    rng = np.random.default_rng(3)
    img = rng.random((24, 32), dtype=np.float32)
    jc = jcamera.PinholeCamera.create(**CAM)
    st = jseed_init.init_seeds(jstate.empty_state(24, 32, jc), jnp.asarray(img),
                               jse3.identity(), js, cfg_j)
    arrays = jax_state_numpy(st)
    back = pstate.state_to_numpy(pstate.state_from_numpy(arrays))
    for k, v in arrays.items():
        if k == "scene":
            for kk, vv in v.items():
                np.testing.assert_array_equal(back["scene"][kk], vv)
        else:
            np.testing.assert_array_equal(back[k], v)
            assert back[k].dtype == v.dtype, k
    pc = pcamera.PinholeCamera.create(**CAM)
    ep = pstate.empty_state(24, 32, pc)
    close(ep.f_ref, jstate.empty_state(24, 32, jc).f_ref)
    assert ep.conv.dtype == torch.int32 and ep.shape == (24, 32)
