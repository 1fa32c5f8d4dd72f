"""The compiled programs on the card: the sweep kernel's device gate
against the plain version, and ``Depthmap`` replays against the eager
``update_step`` they captured, bit for bit, also when the programs are
captured under the profiler while another thread works on the device.

``cuda``-marked: they need a GPU with nvcc and skip elsewhere. The file
imports no JAX, so it runs on the card with ``--noconftest``.
"""

import threading

import numpy as np
import pytest
import torch

import rpg_open_remode_tpu_torch as P
from rpg_open_remode_tpu_torch.models import depthmap as pdm
from rpg_open_remode_tpu_torch.models.state import state_to_numpy
from rpg_open_remode_tpu_torch.ops import sweep_cuda
from rpg_open_remode_tpu_torch.utils import synthetic

W, H = 160, 120
CAM = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)


def _Tcw(fr):
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


def _bounds(fr):
    d = fr.depth[np.isfinite(fr.depth)]
    return float(d.min()), float(d.max())


def _assert_states_equal(got, want):
    g, w = state_to_numpy(got), state_to_numpy(want)
    for name in w:
        if name == "scene":
            for k in w[name]:
                np.testing.assert_array_equal(g[name][k], w[name][k], err_msg=k)
        else:
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [True, False])
def test_sweep_kernel_gate_matches_plain(dev, gate):
    rng = np.random.default_rng(5)
    h, w, pad = 64, 256, 64
    args = [rng.random((h, w + 2 * pad), dtype=np.float32),
            np.tile([[-5.0, w + 5.0]], (h, 1)).astype(np.float32),
            rng.random((h, w), dtype=np.float32), np.ones((h, w), np.float32),
            np.full((h, w), 3.0, np.float32), np.full((h, w), 30.0, np.float32)]
    args = [torch.tensor(a, device=dev) for a in args] + [0.5, 60, pad, 5, True]
    g = torch.tensor(gate, device=dev)
    got = sweep_cuda.disparity_sweep(*args, gate=g)
    want = sweep_cuda.disparity_sweep_plain(*args, gate=g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_replayed_updates_equal_eager_on_the_card(dev):
    lateral = synthetic.generate(n_frames=9, width=W, height=H, cam=CAM, seed=1, step=0.023)
    eng = P.Depthmap(W, H, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"])
    eng.set_reference_image(lateral[0].image, _Tcw(lateral[0]), *_bounds(lateral[0]))
    for fr in lateral[1:]:
        before = eng.state
        eng.update(fr.image, _Tcw(fr))
        want, _ = pdm.update_step(before, eng.input_image(fr.image),
                                  torch.tensor(_Tcw(fr), device=dev), eng.cam, eng.cfg)
        _assert_states_equal(eng.state, want)
    assert any(p.graph is not None and p.replays > 0 for p in eng.programs.cache.values())


@pytest.mark.cuda
def test_capture_beside_a_worker_thread_and_the_profiler(dev):
    """The node captures a reseed while its worker denoises and downloads
    the finished keyframe, and chip_smoke.py captures under torch.profiler:
    a capture must hold against another thread's device work (allocations,
    launches, synchronizing reads) and the profiler's. Every program is
    captured here while a worker loops over what the node's worker does,
    and the replays then equal the eager step."""
    from torch.profiler import ProfilerActivity, profile

    lateral = synthetic.generate(n_frames=6, width=W, height=H, cam=CAM, seed=1, step=0.023)
    cfg = P.RemodeConfig.for_camera(CAM["fx"])
    busy = P.Depthmap(W, H, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"])
    busy.set_reference_image(lateral[0].image, _Tcw(lateral[0]), *_bounds(lateral[0]))
    busy.update(lateral[1].image, _Tcw(lateral[1]))
    snapshot = busy.state
    stop, laps, errors = threading.Event(), [0], []

    def worker():
        try:
            while not stop.is_set():
                pdm.denoise_depthmap(snapshot, cfg, iterations=20).cpu()
                laps[0] += 1
        except BaseException as e:   # reported by the main thread
            errors.append(e)

    thread = threading.Thread(target=worker)
    thread.start()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            eng = P.Depthmap(W, H, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"])
            eng.set_reference_image(lateral[0].image, _Tcw(lateral[0]), *_bounds(lateral[0]))
            for fr in lateral[1:3]:
                eng.update(fr.image, _Tcw(fr))
    finally:
        stop.set()
        thread.join()
    assert not errors, errors
    assert laps[0] > 0
    captured = [p for p in eng.programs.cache.values() if p.graph is not None]
    assert {p.label.split()[0] for p in captured} == {"set_reference", "update"}
    for fr in lateral[3:]:
        before = eng.state
        eng.update(fr.image, _Tcw(fr))
        want, _ = pdm.update_step(before, eng.input_image(fr.image),
                                  torch.tensor(_Tcw(fr), device=dev), eng.cam, eng.cfg)
        _assert_states_equal(eng.state, want)
