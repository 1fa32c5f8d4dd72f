"""The port's engine over the bench protocol's accuracy sequence, and its
profile and roofline scripts (``rpg_open_remode_tpu_torch/scripts/``), on
the CPU at small sizes, against the JAX ``Depthmap``.

Held: the accuracy sequence of the root ``bench.py`` (keyframe, warm-up,
three restored passes, one more update, the accuracy) at 160x120 agrees
between the port's ``Depthmap`` and the JAX one: conv on >= 0.999 of
pixels, converged % within 0.1 point, RMSE, median error and within-2.6 %
to rtol 1e-3; two restored passes end in the same state bit for bit; the
profile scripts print every phase row, and the FULL update_step row's
chain ends in ``update_step``'s own state; without CUDA the scripts
refuse.

The accuracy sequence runs 12 warm-up frames and passes over 10 more (the
protocol's 5 warm-up frames leave too few updates at this size for any
seed to pass the inlier-ratio test, so the sequence would hold nothing).
"""

import json

import numpy as np
import pytest
import torch

import rpg_open_remode_tpu as J
from rpg_open_remode_tpu.utils import synthetic
from rpg_open_remode_tpu_torch.config import ConvergenceState, RemodeConfig
from rpg_open_remode_tpu_torch.models.depthmap import Depthmap, update_step
from rpg_open_remode_tpu_torch.models.state import state_to_numpy
from rpg_open_remode_tpu_torch.scripts import profile_match, profile_update, roofline

torch.set_num_threads(2)
CAM = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)
TINY_CAM = dict(fx=72.0, fy=-71.0, cx=47.5, cy=35.5)


def _as_u8(img):
    """8-bit frames, as a camera gives them."""
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def _Tcw(fr):
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


def _accuracy_sequence(eng, converged_state, frames, warmup, n_pass):
    """bench.py:134-194 on an engine (the JAX or the port's ``Depthmap``):
    keyframe on frame 0 with its depth bounds, ``warmup`` updates, then
    ``n_pass`` passes over the other frames, each from the post-warm-up
    state, one more update of the last frame, and the accuracy against
    frame 0's ground truth. Returns the convergence map and the
    accuracy."""
    f0 = frames[0]
    d0 = f0.depth[np.isfinite(f0.depth)]
    images = [_as_u8(fr.image) for fr in frames]
    poses = [_Tcw(fr) for fr in frames]
    eng.set_reference_image(images[0], poses[0], d0.min(), d0.max())
    for i in range(1, warmup + 1):
        eng.update(images[i], poses[i])
    snap = eng.state
    for _ in range(n_pass):
        eng.state = snap
        for i in range(warmup + 1, len(frames)):
            eng.update(images[i], poses[i])
    eng.update(images[-1], poses[-1])
    conv = eng.convergence_map()
    converged = conv == int(converged_state)
    err = np.abs(eng.depthmap() - f0.depth)[converged]
    return conv, dict(converged_percent=100 * float(converged.mean()),
                      depth_rmse_m=float(np.sqrt(np.mean(err ** 2))),
                      depth_median_err_m=float(np.median(err)),
                      within_2p6pct_range=float((err < 0.026 * (d0.max() - d0.min())).mean()))


def test_accuracy_sequence_matches_jax():
    frames = synthetic.generate(n_frames=23, width=160, height=120, cam=CAM, seed=1, step=0.06)
    cam = dict(fx=CAM["fx"], cx=CAM["cx"], fy=CAM["fy"], cy=CAM["cy"])
    conv, got = _accuracy_sequence(Depthmap(160, 120, **cam, cfg=RemodeConfig(), device="cpu"),
                                   ConvergenceState.CONVERGED, frames, 12, 3)
    want_conv, want = _accuracy_sequence(J.Depthmap(160, 120, **cam, cfg=J.RemodeConfig()),
                                         J.ConvergenceState.CONVERGED, frames, 12, 3)
    assert want["converged_percent"] > 10.0
    assert (conv == want_conv).mean() >= 0.999
    assert abs(got["converged_percent"] - want["converged_percent"]) <= 0.1
    for k in ("depth_rmse_m", "depth_median_err_m", "within_2p6pct_range"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)


def test_restored_passes_end_in_the_same_state():
    """Restoring the snapshot (``eng.state = snap``) before each pass, two
    passes end in equal states, and the snapshot is untouched (no update
    writes into a state's tensors)."""
    frames = synthetic.generate(n_frames=8, width=96, height=72, cam=TINY_CAM, seed=1,
                                step=0.06)
    cam = TINY_CAM
    eng = Depthmap(96, 72, fx=cam["fx"], cx=cam["cx"], fy=cam["fy"], cy=cam["cy"],
                   cfg=RemodeConfig(), device="cpu")
    d0 = frames[0].depth[np.isfinite(frames[0].depth)]
    images = [_as_u8(fr.image) for fr in frames]
    poses = [_Tcw(fr) for fr in frames]
    eng.set_reference_image(images[0], poses[0], d0.min(), d0.max())
    for i in (1, 2):
        eng.update(images[i], poses[i])
    snap = eng.state
    before = state_to_numpy(snap)
    ends = []
    for _ in range(2):
        eng.state = snap
        for i in range(3, 8):
            eng.update(images[i], poses[i])
        ends.append(state_to_numpy(eng.state))
    for a, b in ((ends[0], ends[1]), (before, state_to_numpy(snap))):
        for k in a:
            if k != "scene":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not np.array_equal(ends[0]["mu"], before["mu"])


def test_profile_update_rows_and_full_state():
    rows, full = profile_update.profile(160, 120, "cpu", k=4)
    assert [r["phase"] for r in rows] == ["classify", "match(rect)", "seed_update", "stats",
                                         "FULL update_step", "FULL update_step (replayed)"]
    for r in rows:
        assert r["wall"] > 0 and r["device"] is None and r["busy"] is None
    x = profile_update.setup(160, 120, "cpu", k=4)
    st = x.state
    for i in range(4):
        st, _ = update_step(st, x.imgs[i], x.Ts[i], x.cam, x.cfg)
    for k, v in state_to_numpy(st).items():
        if k != "scene":
            np.testing.assert_array_equal(state_to_numpy(full)[k], v, err_msg=k)


@pytest.mark.parametrize("module, phases", [
    (profile_update, ["classify", "match(rect)", "seed_update", "stats", "FULL update_step",
                      "FULL update_step (replayed)"]),
    (profile_match, ["ref warp (6ch)", "curr warp (wide)", "sweep kernel", "back-warp (3ch)",
                     "FULL match"]),
])
def test_profile_scripts_print_every_phase(module, phases, capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("PROFILE_K", "2")
    monkeypatch.setenv("PROFILE_WARMUP", "3")
    assert module.main(["96x72", "--device", "cpu", "--json", str(tmp_path / "p.json")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu, power limit None W"
    for name in phases:
        # the name column: what precedes the first figure
        row = [ln for ln in lines if " ms/iter" in ln
               and ln.split(" ms/iter")[0].rsplit(None, 1)[0].strip() == name]
        assert len(row) == 1 and "ms/iter wall" in row[0], (name, lines)
    rows = json.loads((tmp_path / "p.json").read_text())["points"]["96x72"]
    assert [r["phase"] for r in rows] == phases


def test_roofline_point_counts_and_bounds_on_the_cpu():
    from rpg_open_remode_tpu_torch.ops.accounting import PEAK_FP32_TFLOPS, PEAK_HBM_GBPS

    out = roofline.point("96x72", 96, 72, 72.0, -71.0, 3, device="cpu")
    assert out["sweep_ms_measured"] is None and out["sweep_pairs"] > 0
    want = max(out["sweep_bytes"] / (PEAK_HBM_GBPS * 1e9),
               out["sweep_gflops_alg"] * 1e9 / (PEAK_FP32_TFLOPS * 1e12)) * 1e3
    assert out["sweep_bound_ms"] == pytest.approx(want, rel=1e-9)
    hp = out["patch"] // 2
    assert out["sweep_gflops_alg"] == pytest.approx(out["sweep_pairs"] * (12 * hp + 11) / 1e9)
    assert out["sweep_gflops_exec"] > out["sweep_gflops_alg"]
    assert [p[0] for p in roofline.POINTS] == ["640x480", "1280x720", "1920x1080"]


@pytest.mark.parametrize("main", [profile_update.main, profile_match.main, roofline.main])
def test_scripts_refuse_without_cuda(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])


def test_card_info_finds_the_card_by_uuid(monkeypatch):
    """Under a remapping CUDA_VISIBLE_DEVICES torch's cuda:0 need not be
    nvidia-smi's first card: card_info picks the line with the device's
    UUID."""
    from types import SimpleNamespace

    from rpg_open_remode_tpu_torch.utils import devices

    listing = ("GPU-aaaa-0000, NVIDIA H100 80GB HBM3, 700.00 W\n"
               "GPU-bbbb-1111, NVIDIA H100 80GB HBM3, 400.00 W\n")
    monkeypatch.setattr(devices.torch.cuda, "get_device_properties",
                        lambda i: SimpleNamespace(uuid="bbbb-1111"))
    monkeypatch.setattr(devices.subprocess, "run",
                        lambda *a, **k: SimpleNamespace(stdout=listing))
    assert devices.card_info("cuda:0") == {"device_name": "NVIDIA H100 80GB HBM3",
                                           "power_limit_w": 400.0}
    monkeypatch.setattr(devices.torch.cuda, "get_device_properties",
                        lambda i: SimpleNamespace(uuid="cccc-2222"))
    with pytest.raises(RuntimeError, match="no card with the UUID"):
        devices.card_info("cuda:0")
    assert devices.card_info("cpu") == {"device_name": "cpu", "power_limit_w": None}


def test_device_busy_is_the_union_before_the_marker():
    """``device_busy_ms``: the union of the device intervals (overlaps
    counted once), only those that start before ``before`` when given;
    None without device activity. Host events never count."""
    from types import SimpleNamespace

    from rpg_open_remode_tpu_torch.utils.profiling import device_busy_ms

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(s, e, dev=cuda):
        return SimpleNamespace(device_type=dev, time_range=SimpleNamespace(start=s, end=e))

    prof = SimpleNamespace(events=lambda: [ev(0, 100), ev(50, 150), ev(300, 400),
                                           ev(120, 900, cpu), ev(1000, 1010)])
    assert device_busy_ms(prof) == pytest.approx(0.26)
    assert device_busy_ms(prof, before=1000) == pytest.approx(0.25)
    assert device_busy_ms(prof, before=0) is None
