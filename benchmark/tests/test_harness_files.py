"""BENCHMARK.json and the files it names: every configuration, traffic mix
and metric is found by name in a file of its own."""

import dataclasses
import json
import re

import pytest

from benchmark import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_names():
    assert set(BENCH) == KEYS
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    c = harness.load_cell(cell, BENCH)
    assert c.config["camera"]["width"] > 0 and c.traffic["loop"] in ("open", "closed")
    # each cell reports setup_s, another end-to-end metric and a per-layer one
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_forward_cell_reports_the_closed_loop_metrics():
    c = harness.load_cell("over_table_640.forward", BENCH)
    assert c.traffic["motion"] == "forward" and c.traffic["loop"] == "closed"
    assert {m["name"] for m in c.end_to_end} == {"frames_per_s", "setup_s"}
    # the generic closed-loop readers; a plane-sweep frame has no
    # rectified sweep for the roofline to count
    assert {m["name"] for m in c.per_layer} == {
        "device_ops_per_frame.offline", "plain_kernel_ms_per_frame.offline",
        "replay_device_ms_p50.offline", "launch_ms_p50.offline", "device_idle_pct.offline",
        "device_wait_ms_per_frame.offline", "stage_ms_p50.offline", "regime_ms_p50.offline",
        "node_self_ms_p50.offline", "keyframes_held_gb.offline"}


@pytest.mark.parametrize("path", sorted((harness.HERE / "limits").glob("*.json")),
                         ids=lambda p: p.stem)
def test_cell_limits_replace_their_configuration_limits(path):
    """A cell's own limits name the cell and numbers that its
    configuration limits, and replace only those."""
    own = json.loads(path.read_text())["limits"]
    c = harness.load_cell(path.stem, BENCH)
    conf = next(x for x in BENCH["configs"]
                if x["name"] == next(w["config"] for w in BENCH["workloads"]
                                     if w["name"] == path.stem))
    base = json.loads((harness.ROOT / conf["file"]).read_text())["limits"]
    assert own and set(own) <= set(base)
    assert c.config["limits"] == dict(base, **own)


@pytest.mark.parametrize("metric", [m["name"] for k in ("end_to_end", "per_layer")
                                    for m in BENCH[k]])
def test_metric_reader_loads_by_name(metric):
    assert callable(harness.reader(metric))


def test_per_layer_metrics_name_their_cells_and_end_to_end_metric():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["workloads"] and set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


def config_faults(conf: dict, data: dict) -> list:
    """What keeps the configuration ``conf`` of BENCHMARK.json, with its
    file's contents ``data``, from running as the program's configuration:
    its ``remode`` must be, field for field, the program's settings for its
    camera (``RemodeConfig.for_camera(fx)``: upstream's defaults at ~481 px,
    the focal scaling above), the reference's ``Config`` must hold the same
    values, nothing may be ``reduced`` (no configuration needs a cut, and a
    cut of the camera or of ``remode`` would change a width), and the limits
    must cover every number compared."""
    from rpg_open_remode_tpu_torch.config import RemodeConfig

    from benchmark import check
    from benchmark.reference.config import Config

    faults = []
    want = RemodeConfig.for_camera(data["camera"]["fx"])
    if RemodeConfig(**data["remode"]) != want:
        faults.append("remode is not RemodeConfig.for_camera(fx)")
    ref = Config(**data["remode"])
    if any(getattr(ref, f.name) != getattr(want, f.name) for f in dataclasses.fields(Config)):
        faults.append("the reference's Config differs")
    if conf["reduced"]:
        faults.append("reduced is not empty")
    if len(conf["source"]) > 200:
        faults.append("source over 200 characters")
    if set(data["limits"]) != set(check.COMPARED) | {"switches_off", "frames_misfiled",
                                                     "captured_in_window"}:
        faults.append("limits")
    return faults


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_runs_as_the_program_config(conf):
    data = json.loads((harness.ROOT / conf["file"]).read_text())
    assert config_faults(conf, data) == []


def _scaled(fx: float, **remode) -> tuple:
    """A configuration at camera ``fx`` with ``for_camera(fx)``'s settings,
    less what ``remode`` overrides, built from the over-table file."""
    from rpg_open_remode_tpu_torch.config import RemodeConfig

    conf = dict(BENCH["configs"][0], reduced=[])
    data = json.loads((harness.ROOT / conf["file"]).read_text())
    data["camera"] = dict(data["camera"], fx=fx)
    data["remode"] = dict(dataclasses.asdict(RemodeConfig.for_camera(fx)), **remode)
    return conf, data


@pytest.mark.parametrize("case, fx, remode, reduced, ok", [
    ("1443.6 px at for_camera's settings", 1443.6, {}, [], True),
    ("reduced cuts the camera", 1443.6, {}, ["camera"], False),
    ("1443.6 px at patch 5", 1443.6, {"patch_side": 5}, [], False),
    ("1443.6 px at the default planes", 1443.6, {"num_planes": 127, "disp_pad": 128}, [],
     False),
    ("481.2 px at patch 7", 481.2, {"patch_side": 7}, [], False),
    ("reduced names a key the file lacks", 1443.6, {}, ["num_hidden_layers"], False),
], ids=lambda v: v if isinstance(v, str) else None)
def test_configuration_check_refuses_drift(case, fx, remode, reduced, ok):
    conf, data = _scaled(fx, **remode)
    conf["reduced"] = reduced
    assert (config_faults(conf, data) == []) == ok, config_faults(conf, data)
