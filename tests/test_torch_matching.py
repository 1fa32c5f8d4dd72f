"""The port's disparity sweep and matcher against the JAX package.

Sweep: the pathological band layouts of tests/test_matching.py, against both
the JAX Pallas sweep (interpret mode) and its XLA sweep. Matcher: the port's
``epipolar.match`` against the JAX one in each motion regime (zero
baseline -> pure rotation, axial -> plane sweep, lateral -> rectified). The
epipolar-walk oracle against the JAX walk, and the fast matchers against it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpg_open_remode_tpu import config as jcfg
from rpg_open_remode_tpu.models import state as jstate
from rpg_open_remode_tpu.ops import epipolar as jepi
from rpg_open_remode_tpu.ops import rect_match as jrect
from rpg_open_remode_tpu.ops import seed_init as jseed_init
from rpg_open_remode_tpu.ops import sweep_pallas as jsweep
from rpg_open_remode_tpu.utils import camera as jcamera
from rpg_open_remode_tpu.utils import synthetic
from rpg_open_remode_tpu_torch import config as pcfg
from rpg_open_remode_tpu_torch import state_from_numpy
from rpg_open_remode_tpu_torch.ops import epipolar as pepi
from rpg_open_remode_tpu_torch.ops import sweep_cuda
from rpg_open_remode_tpu_torch.testing import sweep_cases
from rpg_open_remode_tpu_torch.utils import camera as pcamera
from torch_parity import jax_state_numpy

torch.set_num_threads(2)
CAM_SMALL = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)


def band_layout_inputs():
    """The band layouts of
    tests/test_matching.py::test_pallas_block_skipping_band_layouts."""
    rng = np.random.default_rng(7)
    rect_h, rect_w, pad = 128, 512, 128
    ref = rng.random((rect_h, rect_w), dtype=np.float32)
    curr_pad = rng.random((rect_h, rect_w + 2 * pad), dtype=np.float32)
    # half of it the reference shifted by 20 planes, so bands holding
    # disparity 20 find real peaks (pure noise finds none at patch 9)
    shifted = slice(pad - 20, pad - 20 + rect_w)
    curr_pad[:, shifted] = 0.5 * curr_pad[:, shifted] + 0.5 * ref
    valid = np.ones((rect_h, rect_w), np.float32)
    xlim = np.tile(np.array([[-200.0, rect_w + 200.0]], np.float32), (rect_h, 1))
    lo = np.full((rect_h, rect_w), np.inf, np.float32)
    hi = np.full((rect_h, rect_w), -np.inf, np.float32)
    ramp = np.linspace(5, 100, rect_w, dtype=np.float32)[None, :]
    lo[:40], hi[:40] = ramp - 2, ramp + 2
    lo[70, 300], hi[70, 300] = 0.0, 120.0
    lo[90:110, 250:260], hi[90:110, 250:260] = 17.0, 23.0
    lo[120:, :64], hi[120:, :64] = 120.0, 126.0
    return (curr_pad, xlim, ref, valid, lo, hi), pad


def assert_sweeps_agree(got, want):
    """found agrees on >= 0.999 of pixels; where both found, disparity
    within 1e-3 and NCC within 1e-4."""
    d_p, n_p, f_p = (np.asarray(x) for x in got)
    d_j, n_j, f_j = (np.asarray(x) for x in want)
    f_p, f_j = f_p > 0.5, f_j > 0.5
    assert (f_p == f_j).mean() >= 0.999, (f_p != f_j).mean()
    both = f_p & f_j
    assert both.sum() > 100
    np.testing.assert_allclose(d_p[both], d_j[both], atol=1e-3, rtol=0)
    np.testing.assert_allclose(n_p[both], n_j[both], atol=1e-4, rtol=0)


@pytest.mark.parametrize("patch_side", [5, 9, 15, 17])
def test_sweep_band_layouts_match_jax(patch_side):
    args, pad = band_layout_inputs()
    planes = 127
    cfg = jcfg.RemodeConfig(num_planes=planes, patch_side=patch_side)
    got = sweep_cuda.disparity_sweep(
        *(torch.tensor(a) for a in args), cfg.ncc_threshold, planes, pad,
        patch_side, True,
    )
    jargs = [jnp.asarray(a) for a in args]
    want_xla = jrect._sweep_xla(*jargs, cfg, num_planes=planes, pad=pad,
                                subplane_refine=True)
    assert_sweeps_agree(got, want_xla)
    want_pallas = jsweep.disparity_sweep(*jargs, cfg.ncc_threshold, planes, pad,
                                         patch_side, True)
    assert_sweeps_agree(got, want_pallas)


def _edge_semantics(disp, ncc, found, patch_side):
    """The sweep rules each edge-case group was built to exercise (ROADMAP
    queue 3), at pixels whose patches stay inside their group."""
    D = sweep_cases.D_TRUE

    def rows(name):
        return sweep_cases.edge_interior_rows(name, patch_side)

    x = slice(16, 240)
    # equal NCC at D and D + 32: the strict '>' keeps the lower plane
    r = rows("tie")
    assert found[r, x].all() and (np.round(disp[r, x]) == D).all()
    # best at the band's first / last plane: a masked neighbour, no refinement
    for name in ("best_first", "best_last"):
        r = rows(name)
        assert found[r, x].all() and (disp[r, x] == D).all(), name
    # right neighbour masked by a textureless patch / by the footprint limit
    r = rows("masked_right")
    hp = patch_side // 2
    for c0 in range(128 + 8, 128 + 256 - 16, 24):
        xs = c0 - 128 + D + 1 + hp
        if xs + hp < 256:   # the patch inside the grid (else invalid, not found)
            assert (disp[r.start: r.start + 4, xs] == D).all(), xs
    bottom = slice(r.start + sweep_cases.GROUP_ROWS // 2, r.stop)
    assert found[bottom, 100].all() and (disp[bottom, 100] == D).all()
    # bands at plane 0 (peak at 1, refined) and at K - 1 (right neighbour
    # beyond the cap)
    r = rows("plane_0_and_last")
    assert (np.round(disp[r, 16:112]) == 1).all()
    assert found[r, 144:240].all() and (disp[r, 144:240] == 126).all()

    def none_found(rr, xx):
        return (disp[rr, xx] == -10).all() and (ncc[rr, xx] == -1).all() and not found[rr, xx].any()

    r = sweep_cases.edge_group_rows("no_plane")
    third = 256 // 3
    assert none_found(r, slice(0, third))
    assert none_found(slice(r.start, r.start + sweep_cases.GROUP_ROWS // 2), slice(None))
    assert none_found(r, slice(2 * third, None))
    # +-inf and NaN bounds: only (-inf, inf) and the finite block sweep
    r = sweep_cases.edge_group_rows("inf_nan")
    for i in (0, 2, 3, 4, 5, 6):
        assert none_found(r, slice(32 * i, 32 * i + 32)), i
    ri = rows("inf_nan")
    assert (np.round(disp[ri, 32 + 8: 64 - 8]) == D).all()
    # footprint limits inside the band: the true plane 25 is the last / first
    # admitted plane at x = 85 / x = 225, and cut off at x = 84 / x = 226
    r = rows("xlim_cut")
    assert found[r, 85].all() and (disp[r, 85] == 25).all()
    assert found[r, 225].all() and (disp[r, 225] == 25).all()
    assert (np.round(disp[r, 84]) != 25).all() and (np.round(disp[r, 226]) != 25).all()


@pytest.mark.parametrize("patch_side", [5, 9, 15, 17])
def test_sweep_edge_cases_match_jax(patch_side):
    """The plain sweep against the JAX XLA sweep on hand-built edge cases:
    equal NCC at two planes, a best at a band's first and last plane, a
    masked best+1 neighbour, bands at plane 0 and K-1, bands that admit no
    plane, +-inf and NaN bands, footprint limits that cut a band."""
    args = sweep_cases.edge_cases(patch_side)
    planes, pad = 127, 128
    cfg = jcfg.RemodeConfig(num_planes=planes, patch_side=patch_side)
    got = [t.numpy() for t in sweep_cuda.disparity_sweep(
        *(torch.tensor(a) for a in args), cfg.ncc_threshold, planes, pad, patch_side, True)]
    want = [np.asarray(t) for t in jrect._sweep_xla(
        *(jnp.asarray(a) for a in args), cfg, num_planes=planes, pad=pad, subplane_refine=True)]
    d_p, n_p, f_p = got
    d_j, n_j, f_j = want
    f_j = f_j > 0.5
    np.testing.assert_allclose(n_p, n_j, atol=1e-4, rtol=0)
    near = np.abs(n_p - cfg.ncc_threshold) < 1e-5
    assert (f_p == f_j)[~near].all()
    both = f_p & f_j
    assert both.sum() > 1000
    np.testing.assert_allclose(d_p[both], d_j[both], atol=1e-3, rtol=0)
    for d, n, f in (got, (d_j, n_j, f_j)):
        _edge_semantics(d, n, f, patch_side)


def _Tcw(fr):
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


def _states(frames):
    cfg = jcfg.RemodeConfig()
    f0 = frames[0]
    d = f0.depth[np.isfinite(f0.depth)]
    h, w = f0.image.shape
    st = jseed_init.init_seeds(
        jstate.empty_state(h, w, jcamera.PinholeCamera.create(**CAM_SMALL)),
        jnp.asarray(f0.image), jnp.asarray(f0.T_world_curr),
        jstate.SceneParams.create(d.min(), d.max(), cfg), cfg,
    )
    return st, state_from_numpy(jax_state_numpy(st))


@pytest.mark.parametrize("regime", ["zero_baseline", "axial", "lateral"])
def test_match_regimes_match_jax(regime):
    if regime == "axial":
        frames = synthetic.generate(n_frames=11, width=160, height=120, cam=CAM_SMALL,
                                    seed=4, motion="forward", step=0.046)
        curr = frames[10]
    else:
        frames = synthetic.generate(n_frames=6, width=160, height=120, cam=CAM_SMALL,
                                    seed=3)
        curr = frames[0] if regime == "zero_baseline" else frames[5]
    jst, pst = _states(frames)
    T_ref = np.concatenate([frames[0].T_world_curr, [[0, 0, 0, 1]]])
    T_cur = np.concatenate([curr.T_world_curr, [[0, 0, 0, 1]]])
    T_curr_ref = (np.linalg.inv(T_cur) @ T_ref)[:3].astype(np.float32)
    if regime == "zero_baseline":
        T_curr_ref = np.eye(4, dtype=np.float32)[:3]
    want = jepi.match(jst, jnp.asarray(curr.image), jnp.asarray(T_curr_ref),
                      jcamera.PinholeCamera.create(**CAM_SMALL), jcfg.RemodeConfig())
    got = pepi.match(pst, torch.tensor(curr.image), torch.tensor(T_curr_ref),
                     pcamera.PinholeCamera.create(**CAM_SMALL), pcfg.RemodeConfig())
    fj, fp = np.asarray(want.found), got.found.numpy()
    assert (fj == fp).mean() > 0.995, (fj != fp).mean()
    both = fj & fp
    assert both.mean() > 0.2, both.mean()
    d_ncc = np.abs(got.best_ncc.numpy() - np.asarray(want.best_ncc))[both]
    assert np.quantile(d_ncc, 0.999) < 0.01, np.quantile(d_ncc, 0.999)
    err = np.hypot(got.u.numpy() - np.asarray(want.u), got.v.numpy() - np.asarray(want.v))
    assert np.percentile(err[both], 95) < 0.1, np.percentile(err[both], 95)


def _frame_pair(frames, i):
    T_ref = np.concatenate([frames[0].T_world_curr, [[0, 0, 0, 1]]])
    T_cur = np.concatenate([frames[i].T_world_curr, [[0, 0, 0, 1]]])
    return frames[i].image, (np.linalg.inv(T_cur) @ T_ref)[:3].astype(np.float32)


def test_walk_matches_jax_walk():
    """The walk oracle against the JAX walk on frame 4 of the 160x120
    scene: found equal on >= 0.999 of the pixels, and u, v within 1e-4 on
    >= 0.999 (where the NCC of two steps ties to float32 rounding, the
    other step wins: 1 pixel of 19,200 here)."""
    frames = synthetic.generate(n_frames=5, width=160, height=120, cam=CAM_SMALL, seed=3)
    jst, pst = _states(frames)
    img, T = _frame_pair(frames, 4)
    want = jepi.match_epipolar_walk(jst, jnp.asarray(img), jnp.asarray(T),
                                    jcamera.PinholeCamera.create(**CAM_SMALL),
                                    jcfg.RemodeConfig(match_mode="walk"))
    got = pepi.match(pst, torch.tensor(img), torch.tensor(T),
                     pcamera.PinholeCamera.create(**CAM_SMALL),
                     pcfg.RemodeConfig(match_mode="walk"))
    fj, fp = np.asarray(want.found), got.found.numpy()
    assert (fj == fp).mean() >= 0.999 and fp.mean() > 0.5
    close = ((np.abs(got.u.numpy() - np.asarray(want.u)) <= 1e-4)
             & (np.abs(got.v.numpy() - np.asarray(want.v)) <= 1e-4))
    assert close.mean() >= 0.999, close.mean()


@pytest.mark.parametrize("fast_mode", ["rect", "sweep"])
def test_walk_agrees_with_fast_matchers(fast_mode):
    """tests/test_matching.py: where the port's fast matcher and its walk
    are both confident (NCC > 0.9, 10 px inside), their matches lie within
    a median 1.5 px of each other."""
    frames = synthetic.generate(n_frames=5, width=160, height=120, cam=CAM_SMALL, seed=3)
    _, pst = _states(frames)
    img, T = _frame_pair(frames, 4)
    cam = pcamera.PinholeCamera.create(**CAM_SMALL)
    res = {mode: pepi.match(pst, torch.tensor(img), torch.tensor(T), cam,
                            pcfg.RemodeConfig(match_mode=mode, num_planes=127))
           for mode in (fast_mode, "walk")}
    s, wk = res[fast_mode], res["walk"]
    both = s.found & wk.found & (s.best_ncc > 0.9) & (wk.best_ncc > 0.9)
    interior = torch.zeros_like(both)
    interior[10:-10, 10:-10] = True
    both = (both & interior).numpy()
    assert both.mean() > 0.2, both.mean()
    err = np.hypot(s.u.numpy() - wk.u.numpy(), s.v.numpy() - wk.v.numpy())[both]
    assert np.median(err) < 1.5, np.median(err)
