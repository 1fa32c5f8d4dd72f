"""The port's timing, device, image and visualization utilities against the
JAX package's (``utils/profiling.py``, ``utils/devices.py``,
``utils/image_ops.py``, ``utils/visualize.py``)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpg_open_remode_tpu.utils import camera as jcamera
from rpg_open_remode_tpu.utils import devices as jdevices
from rpg_open_remode_tpu.utils import image_ops as jimage_ops
from rpg_open_remode_tpu.utils import profiling as jprof
from rpg_open_remode_tpu.utils import visualize as jvisualize
from rpg_open_remode_tpu_torch.utils import camera as pcamera
from rpg_open_remode_tpu_torch.utils import devices as pdevices
from rpg_open_remode_tpu_torch.utils import image_ops as pimage_ops
from rpg_open_remode_tpu_torch.utils import profiling as pprof
from rpg_open_remode_tpu_torch.utils import visualize as pvisualize

torch.set_num_threads(2)


def test_metrics_log_writes_the_jax_rows(tmp_path):
    stats = {"converged": torch.tensor(12.0), "dist_from_ref": 0.25, "event": "updated",
             "note": None}
    rows = {}
    for name, mod in (("jax", jprof), ("port", pprof)):
        path = tmp_path / f"{name}.ndjson"
        log = mod.MetricsLog(str(path))
        log.log(3, stats)
        log.log(9, dict(stats, event="keyframe_complete"))
        log.close()
        rows[name] = [json.loads(line) for line in path.read_text().splitlines()]
        assert rows[name] == log.rows
    assert rows["port"] == rows["jax"]
    assert rows["port"][1] == {"frame": 9, "converged": 12.0, "dist_from_ref": 0.25,
                               "event": "keyframe_complete", "note": "None"}


def test_timer_and_force():
    t = pprof.Timer()
    for _ in range(3):
        with t.measure():
            pprof.force(torch.ones(4))
    report = t.report()
    assert report["n"] == 3 and report["mean_s"] >= 0.0 and report["var_s"] >= 0.0
    assert set(report) == set(jprof.Timer().report())
    assert pprof.force(torch.arange(4.0)) == 6.0
    assert pprof.Timer.amortized(lambda i: torch.full((8,), float(i)), n=4) >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    """The tracer's records written as a Chrome trace and read back: each
    span a complete event on its thread with its frame, label and parent,
    a device interval in the device's process, a counter's samples."""
    path = tmp_path / "trace" / "t.json"
    pprof.enable()
    try:
        with pprof.span("node.frame", frame=7):
            with pprof.span("programs.replay", "update uint8"):
                torch.ones(16).sum()
        pprof.gauge("node.keyframes_device_bytes", 3.0)
    finally:
        pprof.disable()
    records = pprof.take()
    outer, inner = records.spans[1], records.spans[0]
    inner.device = (inner.start_ns + 1000, inner.end_ns)
    records.write_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    assert [(e["name"], e["pid"]) for e in spans] == [
        ("programs.replay", 0), ("programs.replay", 1), ("node.frame", 0)]
    host_inner, dev_inner, host_outer = spans
    assert host_inner["tid"] == host_outer["tid"] == inner.thread
    assert host_inner["args"] == {"id": inner.id, "parent": outer.id, "frame": 7,
                                  "label": "update uint8"}
    assert host_outer["ts"] == pytest.approx((outer.start_ns - records.window[0]) / 1e3)
    assert host_outer["dur"] == pytest.approx(outer.ms * 1e3)
    assert dev_inner["ts"] == pytest.approx(host_inner["ts"] + 1.0)
    assert host_outer["ts"] <= host_inner["ts"] <= host_inner["ts"] + host_inner["dur"] <= (
        host_outer["ts"] + host_outer["dur"])
    counters = [e for e in events if e["ph"] == "C"]
    assert [e["args"] for e in counters] == [{"node.keyframes_device_bytes": 3.0}]


def test_check_devices_needs_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pdevices.check_devices(min_devices=0, verbose=True) == []
    assert "cpu" not in capsys.readouterr().out.lower()
    with pytest.raises(RuntimeError, match="CUDA devices"):
        pdevices.check_devices(verbose=False)


@pytest.mark.parametrize("shape", [(8, 2, 2, 2), (8, 1, 2, 2), (4, 4, 1, 1), (1, 1, 1, 1)])
def test_validate_mesh_shape_equals_jax(shape):
    results = []
    for mod in (jdevices, pdevices):
        try:
            mod.validate_mesh_shape(*shape)
            results.append("ok")
        except ValueError as e:
            results.append(str(e))
    assert results[0] == results[1]


@pytest.mark.parametrize("name", ["scharr_x", "scharr_y", "gradient_magnitude", "downsample2"])
def test_image_ops_match_jax(name):
    """The same float32 arithmetic in the same order: within 1e-6 of the
    JAX function (odd sizes, so downsample2 drops a row and a column)."""
    img = np.random.default_rng(3).random((37, 53), dtype=np.float32)
    got = getattr(pimage_ops, name)(torch.tensor(img)).numpy()
    want = np.asarray(getattr(jimage_ops, name)(jnp.asarray(img)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_pyramid_matches_jax():
    img = np.random.default_rng(4).random((64, 96), dtype=np.float32)
    got = pimage_ops.pyramid(torch.tensor(img), 3)
    want = jimage_ops.pyramid(jnp.asarray(img), 3)
    assert [tuple(g.shape) for g in got] == [(64, 96), (32, 48), (16, 24)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_epipolar_pair_equals_jax():
    """The annotated image pair and the fundamental matrix: the same bytes."""
    rng = np.random.default_rng(5)
    ref, curr = rng.random((2, 48, 64), dtype=np.float32)
    T = np.array([[0.999, -0.02, 0.03, 0.1], [0.02, 0.999, 0.01, -0.02],
                  [-0.03, -0.01, 0.999, 0.01]], np.float32)
    cam = dict(fx=48.0, fy=-47.5, cx=31.5, cy=23.5)
    pixels, depths = [(10, 12), (40, 30), (55, 5)], [1.5, 2.0, 3.0]
    got = pvisualize.epipolar_pair(ref, curr, T, pcamera.PinholeCamera.create(**cam), pixels,
                                   depths)
    want = jvisualize.epipolar_pair(ref, curr, T, jcamera.PinholeCamera.create(**cam), pixels,
                                    depths)
    assert got.shape == (48, 128, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    K = np.array([[48.0, 0, 31.5], [0, -47.5, 23.5], [0, 0, 1]])
    np.testing.assert_array_equal(pvisualize.fundamental_matrix(T, K),
                                  jvisualize.fundamental_matrix(T, K))


def test_colorize_depth_equals_jax():
    depth = np.random.default_rng(6).uniform(0.5, 4.0, (30, 40)).astype(np.float32)
    depth[3, 4] = np.nan
    mask = depth < 3.5
    for m in (None, mask):
        np.testing.assert_array_equal(pvisualize.colorize_depth(depth, m),
                                      jvisualize.colorize_depth(depth, m))
