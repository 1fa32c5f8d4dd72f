"""The port's bench, scaling and profile scripts
(``rpg_open_remode_tpu_torch/bench.py``, ``bench_scaling.py``,
``scripts/``) on the CPU at small sizes, against the root ``bench.py``,
``SCALING_r05.json`` and the JAX ``Depthmap``.

Held: the bench line carries every key of ``bench.py``'s ``result`` (read
with ``ast`` from the file) and the scaling line every key of
``SCALING_r05.json``; the bench's accuracy sequence (keyframe, warm-up,
three restored passes, one more update, the accuracy) at 160x120 agrees
with the same sequence through the JAX engine: conv on >= 0.999 of pixels,
converged % within 0.1 point, RMSE, median error and within-2.6 % to rtol
1e-3; two restored passes end in the same state bit for bit; the profile
scripts print every phase row, and the FULL update_step row's chain ends
in ``update_step``'s own state; without CUDA and without ``--device cpu``
the scripts refuse.

The accuracy sequence runs 12 warm-up frames and passes over 10 more (the
protocol's 5 warm-up frames leave too few updates at this size for any
seed to pass the inlier-ratio test, so the sequence would hold nothing).
"""

import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rpg_open_remode_tpu as J
from rpg_open_remode_tpu.utils import synthetic
from rpg_open_remode_tpu_torch import bench, bench_scaling
from rpg_open_remode_tpu_torch.config import RemodeConfig
from rpg_open_remode_tpu_torch.models.depthmap import update_step
from rpg_open_remode_tpu_torch.models.state import state_to_numpy
from rpg_open_remode_tpu_torch.scripts import profile_match, profile_update, roofline

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
CAM = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)
TINY = dict(width=96, height=72, cam=dict(fx=72.0, fy=-71.0, cx=47.5, cy=35.5), step=0.06,
            bound_pad=(1.0, 1.0), n=6, wu=2, n_pass=1)


def _jax_result_keys():
    """The keys of ``result`` in the root bench.py's ``main``."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "result" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no result dict in bench.py")


@pytest.fixture(scope="module")
def bench_line():
    points = {
        "fast_motion": dict(TINY, bound_pad=(0.5, 2.5), cfg=RemodeConfig()),
        "live_752": dict(TINY, cfg=RemodeConfig()),
        "hd_720p": dict(TINY, cfg=None, denoise_n=2),
        "fhd_1080p": dict(TINY, cfg=None, denoise_n=2),
    }
    return bench.run("cpu", width=96, height=72, cam=TINY["cam"], n_frames=8, warmup=2,
                     n_pass=1, node_passes=1, chunk=2, denoise_n=2, points=points)


def test_bench_line_has_every_key_of_the_jax_bench(bench_line):
    want = _jax_result_keys()
    assert len(want) >= 30
    assert want <= set(bench_line), want - set(bench_line)
    assert bench_line["backend"] == "cpu"
    assert bench_line["device_name"] == "cpu" and bench_line["power_limit_w"] is None
    timed = [k for k in bench_line if k.endswith(("_fps", "_ms"))] + ["value"]
    for k in timed:
        assert isinstance(bench_line[k], float) and math.isfinite(bench_line[k]) \
            and bench_line[k] > 0, (k, bench_line[k])
    assert set(bench_line["spread"]) == {"streaming", "node_lifecycle", "offline_chunked",
                                         "offline_staged", *bench.POINTS}
    for name in ("offline_staged", *bench.POINTS):
        for regime in ("young", "steady"):
            assert bench_line["efficiency"][f"{name}_{regime}"]["pairs_full"] > 0
    assert [p["after"] for p in bench_line["h2d_probes"]] == [
        "warmup", "streaming+denoise", "offline", *bench.POINTS, "final"]
    json.dumps(bench_line)


def test_scaling_line_has_every_key_of_scaling_r05():
    out = bench_scaling.run("cpu", width=96, height=72, cam=TINY["cam"], n_frames=14, end=14,
                            n_pass=1)
    want = set(json.loads((ROOT / "SCALING_r05.json").read_text()))
    assert want <= set(out), want - set(out)
    assert out["backend"] == "cpu" and out["device_name"] == "cpu"
    for k in want - {"metric", "backend"}:
        assert math.isfinite(out[k]) and out[k] > 0, (k, out[k])


def _jax_accuracy_sequence(frames, warmup, n_pass):
    """bench.py:134-194 through the JAX engine (its steps, on these
    frames and camera)."""
    from rpg_open_remode_tpu.models.depthmap import Depthmap

    f0 = frames[0]
    d0 = f0.depth[np.isfinite(f0.depth)]
    images = [bench.as_u8(fr.image) for fr in frames]
    poses = [bench._Tcw(fr) for fr in frames]
    eng = Depthmap(160, 120, fx=CAM["fx"], cx=CAM["cx"], fy=CAM["fy"], cy=CAM["cy"],
                   cfg=J.RemodeConfig())
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
    converged = conv == int(J.ConvergenceState.CONVERGED)
    err = np.abs(eng.depthmap() - f0.depth)[converged]
    return conv, dict(converged_percent=100 * float(converged.mean()),
                      depth_rmse_m=float(np.sqrt(np.mean(err ** 2))),
                      depth_median_err_m=float(np.median(err)),
                      within_2p6pct_range=float((err < 0.026 * (d0.max() - d0.min())).mean()))


def test_accuracy_sequence_matches_jax():
    frames = synthetic.generate(n_frames=23, width=160, height=120, cam=CAM, seed=1, step=0.06)
    record = bench.Record("cpu")
    eng, dt, latency, got = bench.stream_point(frames, CAM, RemodeConfig(), 12, 3, "cpu",
                                               record)
    conv, want = _jax_accuracy_sequence(frames, 12, 3)
    assert want["converged_percent"] > 10.0
    assert (eng.convergence_map() == conv).mean() >= 0.999
    assert abs(got["converged_percent"] - want["converged_percent"]) <= 0.1
    for k in ("depth_rmse_m", "depth_median_err_m", "within_2p6pct_range"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    assert len(record.spread["streaming"]["passes_ms_per_frame"]) == 3
    assert dt > 0 and latency > 0


def test_restored_passes_end_in_the_same_state():
    """``timed_passes`` restores the snapshot before each pass; two passes
    end in equal states, and the snapshot is untouched (no update writes
    into a state's tensors)."""
    frames = synthetic.generate(n_frames=8, width=96, height=72, cam=TINY["cam"], seed=1,
                                step=0.06)
    eng = bench._engine(96, 72, TINY["cam"], RemodeConfig(), "cpu")
    d0 = frames[0].depth[np.isfinite(frames[0].depth)]
    images = [bench.as_u8(fr.image) for fr in frames]
    poses = [bench._Tcw(fr) for fr in frames]
    eng.set_reference_image(images[0], poses[0], d0.min(), d0.max())
    for i in (1, 2):
        eng.update(images[i], poses[i])
    snap = eng.state
    before = state_to_numpy(snap)
    steps = [lambda i=i: eng.update(images[i], poses[i]) for i in range(3, 8)]
    ends = []
    for _ in range(2):
        bench.timed_passes(eng, snap, steps, len(steps), 1)
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


@pytest.mark.parametrize("module", ["bench", "bench_scaling"])
def test_bench_refuses_without_cuda(module):
    """No CUDA and no ``--device cpu``: one JSON line with ``error``, exit 1
    (``CUDA_VISIBLE_DEVICES`` is emptied, so no card is visible)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", f"rpg_open_remode_tpu_torch.{module}"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert "CUDA is not available" in line["error"]


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
