"""The plane-sweep matcher as one kernel (``ops/planesweep_cuda.py``).

On the CPU: ``epipolar.match_planesweep_tile`` (the wrapper it dispatches
to) equals the plain loop bit for bit on the whole image with a clamped
halo (64x48 and a ragged 75x48), on a mesh-shaped tile whose seed planes
are smaller than the current image, at patch 5 and 7 and at a plane count
other than 127; ``update_step`` in the ``PLANE_SWEEP`` regime equals the
frame step composed of the plain loop and the plain tail; the kernel's
source is built for the sides the wrapper admits, under a name the
rectified sweep's patterns do not match.

On the card (``cuda``; they skip elsewhere): the kernel against the plain
loop, every output bit for bit, over consecutive frames of a forward dolly
at 640x480 and 752x480, on a ragged mesh-shaped tile, with bands narrowed
so that the kernel skips most planes of a tile, and at
``for_camera(1443.6)`` (patch 15, 383 planes) at a reduced image size; a
captured ``PLANE_SWEEP`` update program launches the kernel once per
replay, as ``LAUNCHES["planesweep"]`` and a profiler trace say. The file
imports no JAX, so it runs on the card with ``--noconftest``.
"""

import dataclasses
import re

import pytest
import torch

import rpg_open_remode_tpu_torch as P
from rpg_open_remode_tpu_torch import kernels
from rpg_open_remode_tpu_torch.config import RemodeConfig
from rpg_open_remode_tpu_torch.models import depthmap as pdm
from rpg_open_remode_tpu_torch.models.state import SeedState
from rpg_open_remode_tpu_torch.ops import epipolar, planesweep_cuda, rect_match, seed_update_cuda
from rpg_open_remode_tpu_torch.testing import planesweep_cases as cases
from rpg_open_remode_tpu_torch.utils import se3

torch.set_num_threads(2)

# (width, height, config overrides, tile (y0, x0, th, tw) or None)
CPU_CASES = {
    "64x48": (64, 48, {}, None),
    "75x48": (75, 48, {}, None),
    "64x48_patch7": (64, 48, {"patch_side": 7}, None),
    "75x48_63_planes": (75, 48, {"num_planes": 63}, None),
    "75x48_tile": (75, 48, {}, (8, 19, 23, 37)),
    "64x48_patch7_tile": (64, 48, {"patch_side": 7}, (0, 24, 31, 40)),
}
OUTPUTS = ("found", "u", "v", "best_ncc")


def _args(width, height, cfg, tile, device="cpu", **kw):
    """The matcher's arguments on the first frame after the warm-up updates
    of a forward dolly, cut to ``tile`` where one is given."""
    x = cases.forward_sequence(width, height, 4, device, cfg=cfg, **kw)
    img, T = x.frames[0]
    state = cases.classified(x.state, x.cfg)
    args = epipolar.planesweep_args(state, img, se3.compose(T, state.T_world_ref), x.cam, x.cfg)
    return args if tile is None else cases.tile_args(args, *tile)


@pytest.mark.parametrize("case", CPU_CASES)
def test_wrapper_equals_the_plain_loop_on_the_cpu(case):
    width, height, overrides, tile = CPU_CASES[case]
    args = _args(width, height, RemodeConfig(**overrides), tile)
    before = dict(kernels.LAUNCHES)
    got = epipolar.match_planesweep_tile(*args)
    want = planesweep_cuda.planesweep_match_plain(*args)
    for name in OUTPUTS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert kernels.LAUNCHES == before
    assert got.found.shape == args[2].shape
    # the case scores planes and finds matches
    assert bool(got.found.any()) and bool((got.best_ncc > -1.0).any())


@pytest.mark.parametrize("size", [(64, 48), (75, 48)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_update_step_in_the_plane_sweep_regime_is_unchanged(size):
    x = cases.forward_sequence(*size, 5, "cpu")
    state = x.state
    for img, T in x.frames:
        T_curr_ref = se3.compose(T, state.T_world_ref)
        assert int(rect_match.regime_device(state, T_curr_ref, x.cam, x.cfg, size[1], size[0])) \
            == rect_match.PLANE_SWEEP
        got, stats = pdm.update_step(state, img, T, x.cam, x.cfg, rect_match.PLANE_SWEEP)

        state1 = cases.classified(state, x.cfg)
        res = planesweep_cuda.planesweep_match_plain(
            *epipolar.planesweep_args(state1, img, T_curr_ref, x.cam, x.cfg))
        want, counts, ncc = seed_update_cuda.seed_update_plain(state1, res, se3.inv(T_curr_ref),
                                                               x.cam, x.cfg)
        for f in dataclasses.fields(SeedState):
            if f.name != "scene":
                assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
        packed = torch.cat([counts.float(), torch.stack([
            torch.linalg.norm(se3.translation(T_curr_ref)), torch.mean(ncc)])])
        assert torch.equal(stats["packed"], packed)
        assert int(counts[0]) > 0
        state = got


def test_kernel_source_takes_the_admitted_sides_under_its_own_name():
    """The C entry point dispatches exactly the sides ``SIDES`` admits, its
    tile is ``TILE``, and its one kernel, ``planesweep_match_kernel``, is not
    matched by the rectified sweep's ``sweep_kernel`` (a substring in
    chip_smoke.py, a word in the benchmark's reader)."""
    src = (kernels.CSRC / "planesweep.cu").read_text()
    cases_ = tuple(int(s) for s in re.findall(r"REMODE_PLANESWEEP_CASE\((\d+)\)\n", src))
    assert cases_ == planesweep_cuda.SIDES
    assert "planesweep.cu" in kernels.SOURCES and "planesweep" in kernels.LAUNCHES
    tile = tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                 for k in ("kTY", "kTX"))
    assert tile == planesweep_cuda.TILE
    names = set(re.findall(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?\s+(\w+)\(",
                           src))
    assert names == {"planesweep_match_kernel"}
    for name in names:
        assert "sweep_kernel" not in name and not re.search(r"\bsweep_kernel\b", name)


def test_planesweep_work_counts_the_frame():
    from rpg_open_remode_tpu_torch.ops.accounting import planesweep_work

    w = planesweep_work(480, 640, 480, 640, 127, 5)
    assert w["pairs"] == 640 * 480 * 127 == 39_014_400
    assert w["flops"] == w["pairs"] * 35
    assert 15e6 < w["bytes"] < 17e6


# -- on the card --------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _mismatches(got, want) -> dict:
    """{output: pixels that differ} of the outputs not equal bit for bit
    (NaN equal to NaN)."""
    out = {}
    for name in OUTPUTS:
        g, w = getattr(got, name), getattr(want, name)
        same = (g == w) | (torch.isnan(g) & torch.isnan(w)) if g.is_floating_point() else g == w
        if not bool(same.all()):
            out[name] = int((~same).sum())
    return out


def _held(args, label, bad, skips=False):
    """The kernel against the plain loop on ``args``, one launch and its
    plane counts; records mismatches under ``label`` in ``bad``."""
    planesweep_cuda.plane_counts(reset=True)
    before = kernels.LAUNCHES["planesweep"]
    got = epipolar.match_planesweep_tile(*args)
    assert kernels.LAUNCHES["planesweep"] == before + 1
    counts = planesweep_cuda.plane_counts()
    want = planesweep_cuda.planesweep_match_plain(*args)
    if m := _mismatches(got, want):
        bad[label] = m
    th, tw = args[2].shape
    cfg = args[-1]
    rows, cols = planesweep_cuda.TILE
    assert counts["pairs"] == -(-th // rows) * -(-tw // cols) * cfg.num_planes
    if skips:
        assert counts["skipped"] > counts["pairs"] // 2, counts
    assert bool(want.found.any())


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(640, 480), (752, 480)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_matches_plain_on_forward_frames(dev, size):
    x = cases.forward_sequence(*size, 8, dev)
    state, bad = x.state, {}
    for i, (img, T) in enumerate(x.frames):
        st = cases.classified(state, x.cfg)
        T_curr_ref = se3.compose(T, st.T_world_ref)
        assert int(rect_match.regime_device(st, T_curr_ref, x.cam, x.cfg, size[1], size[0])) \
            == rect_match.PLANE_SWEEP
        args = epipolar.planesweep_args(st, img, T_curr_ref, x.cam, x.cfg)
        _held(args, (i, "whole"), bad)
        if i == 0:
            # a ragged mesh-shaped tile, and bands of a few planes
            _held(cases.tile_args(args, 100, 150, 173, 261), (i, "tile"), bad)
            narrow = cases.classified(cases.narrowed(state, 1e-3), x.cfg)
            _held(epipolar.planesweep_args(narrow, img, T_curr_ref, x.cam, x.cfg),
                  (i, "narrow"), bad, skips=True)
        state, _ = pdm.update_step(state, img, T, x.cam, x.cfg)
    assert not bad, bad


@pytest.mark.cuda
def test_kernel_matches_plain_at_patch_15_and_383_planes(dev):
    cfg = RemodeConfig.for_camera(1443.6)
    assert (cfg.patch_side, cfg.num_planes) == (15, 383)
    w, h = 480, 272
    cam = dict(fx=1443.6, fy=-1440.0, cx=(w - 1) / 2, cy=(h - 1) / 2)
    args, bad = _args(w, h, cfg, None, dev, cam=cam), {}
    _held(args, "whole", bad)
    _held(cases.tile_args(args, 37, 61, 150, 203), "tile", bad)
    assert not bad, bad


@pytest.mark.cuda
def test_one_planesweep_launch_per_replay(dev):
    from torch.profiler import ProfilerActivity, profile

    w, h = 160, 120
    cam = cases.camera_for(w, h)
    frames = cases.render_forward(w, h, 6, cam, seed=4)
    eng = P.Depthmap(w, h, cam["fx"], cam["cx"], cam["fy"], cam["cy"])
    f0 = frames[0]
    d = f0.depth[f0.depth == f0.depth]
    eng.set_reference_image(f0.image, cases.Tcw(f0), float(d.min()), float(d.max()))
    for fr in frames[1:4]:
        T = cases.Tcw(fr)
        assert eng.programs.regime(T) == rect_match.PLANE_SWEEP
        eng.update(fr.image, T)            # the first: warm-up and capture
    prog = eng.programs.program("update", torch.float32, None, rect_match.PLANE_SWEEP)
    assert prog.graph is not None and prog.launches["planesweep"] == 1
    kernels.reset_launches()
    T = cases.Tcw(frames[4])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for n in range(1, 4):
            eng.update(frames[4].image, T)
            assert kernels.LAUNCHES["planesweep"] == n
        torch.cuda.synchronize()
    traced = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and "planesweep_match_kernel" in e.name]
    assert len(traced) == kernels.LAUNCHES["planesweep"] == 3
    assert kernels.LAUNCHES["seed_update"] == 3 and kernels.LAUNCHES["sweep"] == 0
