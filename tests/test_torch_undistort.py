"""The port's lens undistortion against the JAX package's: the remap grid
(``models/depthmap.undistort_map``), the facade's ``init_undistortion_map``
and ``input_image``, and the facade's rule that a grid turns keyframe
propagation off (both packages seed every keyframe flat when a grid is set).
The JAX package's own checks are tests/test_utils_aux.py::TestUndistortion.
"""

import numpy as np
import pytest
import torch

import rpg_open_remode_tpu as J
from rpg_open_remode_tpu.models import depthmap as jdepthmap
from rpg_open_remode_tpu.utils import camera as jcamera
from rpg_open_remode_tpu.utils import synthetic
import rpg_open_remode_tpu_torch as P
from rpg_open_remode_tpu_torch.models import depthmap as pdepthmap
from rpg_open_remode_tpu_torch.utils import camera as pcamera

torch.set_num_threads(2)
CAM = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)
HARDEN = dict(noise_sigma=0.01, vignette=0.15, n_textureless=3, n_spheres=2)
# (k1, k2, p1, p2): none, radial only, radial and tangential, barrel
DISTORTIONS = [(0.0, 0.0, 0.0, 0.0), (0.08, -0.01, 0.0, 0.0),
               (0.08, -0.01, 0.001, -0.002), (-0.2, 0.05, -0.003, 0.002)]
LENS = (0.05, -0.01, 0.001, -0.002)


def _Tcw(fr):
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


@pytest.mark.parametrize("coeffs", DISTORTIONS)
def test_undistort_map_matches_jax(coeffs):
    """The plumb-bob remap grid: the same float32 operations in the same
    order, so within a few ulp of the pixel coordinate."""
    cam_p = pcamera.PinholeCamera.create(50.0, -49.0, 31.5, 23.5, device="cpu")
    cam_j = jcamera.PinholeCamera.create(fx=50.0, fy=-49.0, cx=31.5, cy=23.5)
    got = pdepthmap.undistort_map(48, 64, cam_p, *coeffs)
    want = jdepthmap.undistort_map(48, 64, cam_j, *coeffs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-5)


def test_input_image_matches_jax():
    """``init_undistortion_map`` + ``input_image`` on an 8-bit frame: uint8
    to [0, 1], then the grid warp."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (120, 160), dtype=np.uint8)
    engines = [P.Depthmap(160, 120, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"], device="cpu"),
               J.Depthmap(160, 120, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"])]
    before = engines[0].input_image(img).numpy()
    for eng in engines:
        eng.init_undistortion_map(*LENS)
    got, want = engines[0].input_image(img).numpy(), np.asarray(engines[1].input_image(img))
    assert got.shape == (120, 160) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got - before).max() > 0.05   # the grid does warp the frame


def test_grid_turns_propagation_off_as_in_jax():
    """A port ``Depthmap`` and a JAX one with the same grid and
    ``propagate_depth`` on: set the reference, update, switch keyframe,
    update. Both seed the second keyframe flat (the grid turns propagation
    off), and the two engines agree: conv on >= 0.999 of pixels, mu within
    rtol 1e-4 on >= 0.99 of them (the warped frames differ by an ulp, which
    moves a few knife-edge NCC peaks; 0.9969 read at this size)."""
    frames = synthetic.generate(n_frames=14, width=160, height=120, cam=CAM, seed=2,
                                step=0.06, **HARDEN)
    d = frames[0].depth[np.isfinite(frames[0].depth)]
    bounds = (float(d.min()), float(d.max()))
    cfgs = (P.RemodeConfig(propagate_depth=True), J.RemodeConfig(propagate_depth=True))
    engines = [pkg.Depthmap(160, 120, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"], cfg=cfg, **kw)
               for pkg, cfg, kw in ((P, cfgs[0], dict(device="cpu")), (J, cfgs[1], {}))]
    for eng in engines:
        eng.init_undistortion_map(*LENS)
    maps = []
    for eng in engines:
        eng.set_reference_image(frames[0].image, _Tcw(frames[0]), *bounds)
        for fr in frames[1:10]:
            eng.update(fr.image, _Tcw(fr))
        conv_kf0 = eng.convergence_map()
        eng.set_reference_image(frames[10].image, _Tcw(frames[10]), *bounds)
        sigma_sq = np.asarray(eng.state.sigma_sq)
        flat = float(np.asarray(eng.state.scene.sigma_sq_max))
        # a propagated seed carries a narrowed variance; every seed is flat
        assert (sigma_sq == flat).all()
        assert (np.asarray(eng.state.mu) == float(np.asarray(eng.state.scene.avg_depth))).all()
        for fr in frames[11:]:
            eng.update(fr.image, _Tcw(fr))
        maps.append((conv_kf0, eng.convergence_map(), eng.depthmap()))
    (c0_p, c1_p, mu_p), (c0_j, c1_j, mu_j) = maps
    assert (c0_p == int(P.ConvergenceState.UPDATE)).mean() < 0.999  # the first keyframe matched
    assert np.mean(c0_p == c0_j) >= 0.999
    assert np.mean(c1_p == c1_j) >= 0.999
    frac = np.mean(np.abs(mu_p - mu_j) <= 1e-4 * np.abs(mu_j))
    assert frac >= 0.99, frac
    # and without a grid the same port engine does propagate
    eng = P.Depthmap(160, 120, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"], cfg=cfgs[0],
                     device="cpu")
    eng.set_reference_image(frames[0].image, _Tcw(frames[0]), *bounds)
    for fr in frames[1:10]:
        eng.update(fr.image, _Tcw(fr))
    eng.set_reference_image(frames[10].image, _Tcw(frames[10]), *bounds)
    assert (eng.state.sigma_sq != eng.state.scene.sigma_sq_max).any()
