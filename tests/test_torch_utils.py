"""The port's timing and device utilities against the JAX package's
(``utils/profiling.py``, ``utils/devices.py``)."""

import json

import pytest
import torch

from rpg_open_remode_tpu.utils import devices as jdevices
from rpg_open_remode_tpu.utils import profiling as jprof
from rpg_open_remode_tpu_torch.utils import devices as pdevices
from rpg_open_remode_tpu_torch.utils import profiling as pprof

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
    path = tmp_path / "trace" / "t.json"
    with pprof.trace(str(path)) as prof:
        torch.ones(16).sum()
    assert prof is not None and path.is_file()


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
