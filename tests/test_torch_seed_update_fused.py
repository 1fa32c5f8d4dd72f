"""The frame step's fused tail (``ops/seed_update_cuda.py``).

On the CPU: ``update_step`` equals the composition it was before the
kernel (the matcher, ``epipolar.apply_match_to_conv``,
``seed_update.update_seeds``, ``reduction.convergence_stats`` and the
found-masked mean NCC) bit for bit in each matcher regime, at 64x48 and
at a ragged 75x48; and the wrapper's plain version equals that
composition on states and matches made to hit every branch: the
behind-camera and NaN sentinels, NO_MATCH, BORDER and CONVERGED.

On the card (``cuda``; they skip elsewhere): the kernel against its
plain version at 640x480 and 752x480 over consecutive frames of
``scripts/profile_update.setup``, every leaf bit for bit, in both
flavours and with the pose-noise terms on; and a captured update program launches the kernel once per
replay in each regime. The file imports no JAX, so it runs on the card
with ``--noconftest``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import rpg_open_remode_tpu_torch as P
from rpg_open_remode_tpu_torch import kernels
from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig
from rpg_open_remode_tpu_torch.models import depthmap as pdm
from rpg_open_remode_tpu_torch.models.state import SceneParams, SeedState, empty_state
from rpg_open_remode_tpu_torch.ops import (
    epipolar, rect_match, reduction, seed_check, seed_init, seed_update, seed_update_cuda,
)
from rpg_open_remode_tpu_torch.ops.triangulation import triangulate_midpoint
from rpg_open_remode_tpu_torch.utils import se3, synthetic
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera

torch.set_num_threads(2)
UPDATE, CONVERGED, BORDER, NO_MATCH = (int(ConvergenceState[k]) for k in (
    "UPDATE", "CONVERGED", "BORDER", "NO_MATCH"))
SIZES = [(64, 48), (75, 48)]
REGIMES = {"rectified": rect_match.RECTIFIED, "pure_rotation": rect_match.PURE_ROTATION,
           "plane_sweep": rect_match.PLANE_SWEEP}


def _Tcw(fr):
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


def _camera(width, height):
    s = width / 640.0
    return dict(fx=481.2 * s, fy=-480.0 * s, cx=(width - 1) / 2, cy=(height - 1) / 2)


def _sequence(width, height, regime):
    """(camera, config, the keyframe's state after two updates, the
    measured frame's image and pose): a lateral dolly (its frame 4, or the
    keyframe's own pose for a pure rotation) or a forward one (frame 8)."""
    cam = _camera(width, height)
    forward = regime == "plane_sweep"
    frames = synthetic.generate(n_frames=9, width=width, height=height, cam=cam, seed=1,
                                motion="forward" if forward else "lateral",
                                step=0.046 if forward else 0.023)
    cfg = RemodeConfig()
    pcam = PinholeCamera.create(**cam)
    f0 = frames[0]
    d = f0.depth[np.isfinite(f0.depth)]
    state = seed_init.init_seeds(
        empty_state(height, width, pcam), torch.tensor(f0.image),
        torch.tensor(f0.T_world_curr), SceneParams.create(d.min(), d.max(), cfg), cfg)
    for fr in frames[1:3]:
        state, _ = pdm.update_step(state, torch.tensor(fr.image), torch.tensor(_Tcw(fr)),
                                   pcam, cfg)
    at = {"rectified": frames[4], "pure_rotation": f0, "plane_sweep": frames[8]}[regime]
    return pcam, cfg, state, torch.tensor(at.image), torch.tensor(_Tcw(at))


def _classified(state, cfg):
    h, w = state.shape
    border = seed_check.border_mask(h, w, cfg, device=state.mu.device)
    conv1 = seed_check.classify_seeds(state.mu, state.sigma_sq, state.a, state.b,
                                      state.scene.epsilon, border, cfg)
    return dataclasses.replace(state, conv=conv1)


def _composition(state1, res, T_ref_curr, cam, cfg):
    """The frame step's tail as it was composed before the kernel."""
    active = state1.conv == UPDATE
    conv2 = epipolar.apply_match_to_conv(state1.conv, active, res.found)
    new = seed_update.update_seeds(state1, conv2, res.u, res.v, T_ref_curr, cam, cfg)
    stats = reduction.convergence_stats(conv2)
    mean_ncc = torch.mean(torch.where(res.found, res.best_ncc, torch.zeros_like(res.best_ncc)))
    return new, stats, mean_ncc


def _assert_states_equal(got: SeedState, want: SeedState):
    for f in dataclasses.fields(SeedState):
        if f.name != "scene":
            assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_update_step_equals_the_composition(size, regime):
    cam, cfg, state, img, T = _sequence(*size, regime)
    T_curr_ref = se3.compose(T, state.T_world_ref)
    assert int(rect_match.regime_device(state, T_curr_ref, cam, cfg, size[1], size[0])) \
        == REGIMES[regime]
    got, stats = pdm.update_step(state, img, T, cam, cfg, REGIMES[regime])

    state1 = _classified(state, cfg)
    matcher = (rect_match.match_pure_rotation, epipolar.match_planesweep,
               rect_match.match_rectified)[REGIMES[regime]]
    res = matcher(state1, pdm.prep_image(img), T_curr_ref, cam, cfg)
    want, counts, mean_ncc = _composition(state1, res, se3.inv(T_curr_ref), cam, cfg)
    _assert_states_equal(got, want)
    want_stats = dict(counts, dist_from_ref=torch.linalg.norm(se3.translation(T_curr_ref)),
                      mean_ncc=mean_ncc)
    packed = torch.stack([want_stats[k].float() for k in pdm.PACKED_STATS_KEYS])
    assert torch.equal(stats["packed"], packed)
    for k in seed_update_cuda.COUNT_KEYS:
        assert stats[k].dtype == torch.int32 and torch.equal(stats[k], counts[k]), k
    assert counts["update"] > 0


def _sentinel_state(state, rng):
    """``state`` with seeds set to hit the update's guards: a third of the
    pixels converged (tiny variance, inlier-heavy), a tenth with a = b = 0
    (classified UPDATE; the update's inlier weight is 0/0, the NaN
    sentinel)."""
    h, w = state.shape
    conv_m = torch.from_numpy(rng.random((h, w)) < 0.3)
    nan_m = torch.from_numpy(rng.random((h, w)) < 0.1) & ~conv_m
    a = torch.where(conv_m, torch.full_like(state.a, 60.0), state.a)
    sigma_sq = torch.where(conv_m, state.scene.epsilon * 0.5, state.sigma_sq)
    a = torch.where(nan_m, torch.zeros_like(a), a)
    b = torch.where(nan_m, torch.zeros_like(state.b), state.b)
    return dataclasses.replace(state, a=a, b=b, sigma_sq=sigma_sq), nan_m


@pytest.mark.parametrize("flavour", ["rectified", "generic"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_version_equals_the_composition_on_every_branch(size, flavour):
    rng = np.random.default_rng(7)
    cam, cfg, state, img, T = _sequence(*size, "rectified")
    state, nan_m = _sentinel_state(state, rng)
    state1 = _classified(state, cfg)
    T_curr_ref = se3.compose(T, state.T_world_ref)
    T_ref_curr = se3.inv(T_curr_ref)
    h, w = state.shape
    planes = rect_match.match_rectified_planes(state1, pdm.prep_image(img), T_curr_ref, cam, cfg)
    # a fifth of the pixels lose their match (NO_MATCH); a tenth take a
    # negative disparity, whose rays meet behind the reference camera
    lost = torch.from_numpy(rng.random((h, w)) < 0.2)
    behind = torch.from_numpy(rng.random((h, w)) < 0.1)
    back = planes.back.clone()
    back[2] = torch.where(lost, torch.zeros_like(back[2]), back[2])
    back[0] = torch.where(behind, -20.0 * back[2], back[0])
    planes = planes._replace(back=back)
    res = rect_match.unrectify(planes, cfg)
    match = planes if flavour == "rectified" else res

    got, counts, ncc = seed_update_cuda.fused_seed_update(state1, match, T_ref_curr, cam, cfg)
    want, want_counts, mean_ncc = _composition(state1, res, T_ref_curr, cam, cfg)
    _assert_states_equal(got, want)
    assert torch.equal(counts, torch.stack([want_counts[k] for k in seed_update_cuda.COUNT_KEYS]))
    assert torch.equal(torch.mean(ncc), mean_ncc)

    # every branch is taken
    conv2 = want.conv
    updated = conv2 == UPDATE
    f_curr = cam.cam2world(res.u, res.v)
    f_curr = f_curr / torch.linalg.norm(f_curr, dim=-1, keepdim=True)
    pt = triangulate_midpoint(torch.movedim(state1.f_ref, 0, -1), f_curr, T_ref_curr)
    assert (updated & (pt[..., 2] < 0) & ~nan_m).any()                  # behind the camera
    assert (updated & nan_m).any()                                      # NaN sentinel
    assert torch.equal(want.mu[updated & nan_m], state1.mu[updated & nan_m])
    for s in (NO_MATCH, BORDER, CONVERGED):
        assert (conv2 == s).any(), s
    moved = updated & (want.mu != state1.mu)
    assert moved.any()


# -- on the card --------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance in units in the last place between two float32
    tensors (NaNs of either sign equal)."""
    g, w = got.view(torch.int32).long(), want.view(torch.int32).long()
    # map the sign-magnitude bit patterns onto a monotonic integer line
    g = torch.where(g < 0, -(g & 0x7FFFFFFF), g)
    w = torch.where(w < 0, -(w & 0x7FFFFFFF), w)
    both_nan = torch.isnan(got) & torch.isnan(want)
    return int(torch.where(both_nan, 0, (g - w).abs()).max())


def _leaf_mismatches(got, want) -> dict:
    """{leaf: (pixels that differ, largest ULP distance)} of the leaves that
    are not equal bit for bit (NaN equal to NaN)."""
    (g_state, g_counts, g_ncc), (w_state, w_counts, w_ncc) = got, want
    leaves = {f: (getattr(g_state, f), getattr(w_state, f))
              for f in ("mu", "sigma_sq", "a", "b", "conv", "match_u", "match_v")}
    leaves.update(counts=(g_counts, w_counts), ncc=(g_ncc, w_ncc))
    out = {}
    for name, (g, w) in leaves.items():
        same = (g == w) | (torch.isnan(g) & torch.isnan(w)) if g.is_floating_point() else g == w
        if not bool(same.all()):
            n = int((~same).sum())
            out[name] = (n, _ulps(g, w) if g.is_floating_point() else None)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(640, 480), (752, 480)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_matches_plain_on_the_card(dev, size):
    from rpg_open_remode_tpu_torch.scripts.profile_update import setup

    x = setup(*size, dev, k=4, warmup=8)
    # the pose-noise terms of the uncertainty, on for the last frame
    noisy = dataclasses.replace(x.cfg, pose_noise_rot_deg=0.5, pose_noise_trans_m=0.003)
    state = x.state
    mismatches = {}
    for i in range(8, 12):
        cfg = noisy if i == 11 else x.cfg
        img = pdm.prep_image(x.imgs[i])
        T_curr_ref = se3.compose(x.Ts[i], state.T_world_ref)
        T_ref_curr = se3.inv(T_curr_ref)
        state1 = _classified(state, cfg)
        planes = rect_match.match_rectified_planes(state1, img, T_curr_ref, x.cam, cfg)
        res = rect_match.unrectify(planes, cfg)
        for flavour, match in (("rectified", planes), ("generic", res)):
            before = kernels.LAUNCHES["seed_update"]
            got = seed_update_cuda.fused_seed_update(state1, match, T_ref_curr, x.cam, cfg)
            assert kernels.LAUNCHES["seed_update"] == before + 1
            want = seed_update_cuda.seed_update_plain(state1, match, T_ref_curr, x.cam, cfg)
            bad = _leaf_mismatches(got, want)
            if bad:
                mismatches[(i, flavour)] = bad
        state = want[0]
    assert not mismatches, mismatches


@pytest.mark.cuda
def test_one_seed_update_launch_per_replay_in_each_regime(dev):
    w, h = 160, 120
    cam = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)
    lateral = synthetic.generate(n_frames=5, width=w, height=h, cam=cam, seed=1, step=0.023)
    forward = synthetic.generate(n_frames=9, width=w, height=h, cam=cam, seed=4,
                                 motion="forward", step=0.046)
    seen = set()
    for frames, cases in ((lateral, (4, 0)), (forward, (8,))):
        eng = P.Depthmap(w, h, cam["fx"], cam["cx"], cam["fy"], cam["cy"])
        f0 = frames[0]
        d = f0.depth[np.isfinite(f0.depth)]
        eng.set_reference_image(f0.image, _Tcw(f0), float(d.min()), float(d.max()))
        for j in cases:
            T = _Tcw(frames[j])
            regime = eng.programs.regime(T)
            eng.update(frames[j].image, T)            # warm-up and capture
            prog = eng.programs.program("update", torch.float32, None, regime)
            assert prog.graph is not None and prog.launches["seed_update"] == 1
            kernels.reset_launches()
            for n in range(1, 4):
                eng.update(frames[j].image, T)
                assert kernels.LAUNCHES["seed_update"] == n
            seen.add(regime)
    assert set(seen) == set(REGIMES.values())
