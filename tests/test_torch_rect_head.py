"""The rectified frame step's head as hand kernels (``ops/rect_head_cuda.py``).

``rect_match.prepare_sweep`` and ``match_rectified_planes`` chain pieces
that each run their plain version on the CPU and their kernel on the card
(``seed_check.classify`` likewise). On the CPU: each piece and the chains
equal the walk of the plain pieces (``testing/rect_head_cases.
head_mismatches``) bit for bit at 640x480 and 752x480 in each case of
``testing/rect_head_cases``: the coarse gate on (a young keyframe) and off,
stragglers present, and no valid rect pixel (kbase 0); and ``update_step``
in the rectified regime equals the step composed of the plain pieces.

On the card (``cuda``; they skip elsewhere): the same holds with each
piece's kernel, on the first updates of the synthetic lateral stream at
640x480 and 752x480 and on the same cases, and at 1280x720 and 1920x1080
at their focal-scaled configs; then the launch record of one replayed
update in each regime. The file imports no JAX, so it runs on the card
with ``--noconftest``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import rpg_open_remode_tpu_torch as P
from rpg_open_remode_tpu_torch import kernels
from rpg_open_remode_tpu_torch.models import depthmap as pdm
from rpg_open_remode_tpu_torch.ops import rect_match, seed_update_cuda
from rpg_open_remode_tpu_torch.testing import rect_head_cases as cases
from rpg_open_remode_tpu_torch.utils import se3, synthetic

torch.set_num_threads(2)
SIZES = [(640, 480), (752, 480)]
HEAD = ("classify", "rect_geometry", "ref_fruitless", "ref_bands", "rect_bands", "rect_rebase",
        "coarse_narrow", "back_stack")


@functools.lru_cache(maxsize=None)
def _stream(width, height, device="cpu"):
    return cases.lateral_stream(width, height, device)


# -- on the CPU ----------------------------------------------------------------


@pytest.mark.parametrize("case", cases.CASES)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_route_equals_the_composition(size, case):
    cam, cfg, steps = _stream(*size)
    state, img, T_curr_ref = cases.case(steps[cases.CASE_STEP[case]], cfg, case)
    assert not cases.head_mismatches(cam, cfg, state, img, T_curr_ref)
    # the case is the one named
    p = rect_match.prepare_sweep(state, img, T_curr_ref, cam, cfg)
    gate, kbase = bool(p["gate"]), float(p["kbase"])
    if case == "gate_on":
        assert gate
    elif case == "gate_off":
        assert not gate and kbase > 0
    elif case == "stragglers":
        flag, _ = rect_match.straggler_flag(state.a, state.b, cfg)
        assert flag.sum() > 1000
    else:
        planes = rect_match.match_rectified_planes(state, img, T_curr_ref, cam, cfg)
        assert kbase == 0 and not gate and not bool(planes.back[2].any())


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_update_step_equals_the_composition(size):
    cam, cfg, steps = _stream(*size)
    state, img, T = steps[3]
    got, stats = pdm.update_step(state, img, T, cam, cfg, rect_match.RECTIFIED)

    T_curr_ref = se3.compose(T, state.T_world_ref)
    state1 = cases.classified(state, cfg)
    planes = rect_match.match_rectified_planes(state1, pdm.prep_image(img), T_curr_ref, cam, cfg)
    want, counts, ncc = seed_update_cuda.seed_update_plain(state1, planes, se3.inv(T_curr_ref),
                                                           cam, cfg)
    assert not cases.mismatches(dataclasses.asdict(got), dataclasses.asdict(want))
    packed = torch.cat([counts.float(), torch.stack([
        torch.linalg.norm(se3.translation(T_curr_ref)), torch.mean(ncc)])])
    assert torch.equal(stats["packed"], packed)
    assert int(stats["update"]) > 0


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernels_match_plain_on_the_card(dev, size):
    cam, cfg, steps = _stream(*size, device="cuda")
    bad, gates = {}, set()
    for i, name in cases.runs(steps):
        state, img, T_curr_ref = cases.case(steps[i], cfg, name)
        found = cases.head_mismatches(cam, cfg, state, img, T_curr_ref)
        if found:
            bad[(i, name)] = found
        gates.add(bool(rect_match.prepare_sweep(state, img, T_curr_ref, cam, cfg)["gate"]))
    assert not bad, bad
    assert gates == {True, False}


@pytest.mark.cuda
@pytest.mark.parametrize("camera", [(1280, 720, 962.4, -960.0), (1920, 1080, 1443.6, -1440.0)],
                         ids=lambda c: f"{c[0]}x{c[1]}")
def test_kernels_match_plain_at_the_focal_scaled_configs(dev, camera):
    # another patch side, disparity pad and rect grid than at 481.2
    w, h, fx, fy = camera
    cam, cfg, steps = cases.lateral_stream(w, h, "cuda", fx=fx, fy=fy)
    bad = {}
    for i, name in cases.runs(steps):
        found = cases.head_mismatches(cam, cfg, *cases.case(steps[i], cfg, name))
        if found:
            bad[(i, name)] = found
    assert not bad, bad


def _Tcw(fr):
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


@pytest.mark.cuda
def test_launches_of_one_replayed_update_in_each_regime(dev):
    w, h = 160, 120
    cam = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)
    lateral = synthetic.generate(n_frames=5, width=w, height=h, cam=cam, seed=1, step=0.023)
    forward = synthetic.generate(n_frames=9, width=w, height=h, cam=cam, seed=4,
                                 motion="forward", step=0.046)
    seen = {}
    for frames, picks in ((lateral, (4, 0)), (forward, (8,))):
        eng = P.Depthmap(w, h, cam["fx"], cam["cx"], cam["fy"], cam["cy"])
        f0 = frames[0]
        d = f0.depth[np.isfinite(f0.depth)]
        eng.set_reference_image(f0.image, _Tcw(f0), float(d.min()), float(d.max()))
        for j in picks:
            T = _Tcw(frames[j])
            regime = eng.programs.regime(T)
            eng.update(frames[j].image, T)            # warm-up and capture
            prog = eng.programs.program("update", torch.float32, None, regime)
            kernels.reset_launches()
            eng.update(frames[j].image, T)
            assert prog.graph is not None and kernels.LAUNCHES == prog.launches
            seen[regime] = {k: n for k, n in prog.launches.items() if n}
    head = dict.fromkeys(HEAD, 1)
    assert seen[rect_match.RECTIFIED] == head | {"sweep": 2, "warp": 3, "seed_update": 1}
    assert seen[rect_match.PURE_ROTATION] == {"classify": 1, "warp": 1, "seed_update": 1}
    assert seen[rect_match.PLANE_SWEEP] == {"classify": 1, "planesweep": 1, "seed_update": 1}
