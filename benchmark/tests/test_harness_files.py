"""BENCHMARK.json and the files it names: every configuration, traffic mix
and metric is found by name in a file of its own."""

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


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_runs_as_the_program_config(conf):
    from rpg_open_remode_tpu_torch.config import RemodeConfig

    from benchmark.reference.config import Config

    data = json.loads((harness.ROOT / conf["file"]).read_text())
    assert RemodeConfig(**data["remode"]) == RemodeConfig()
    assert Config(**data["remode"]) == Config()
    assert conf["reduced"] == [] and len(conf["source"]) <= 200
    from benchmark import check

    assert set(data["limits"]) == set(check.COMPARED) | {"switches_off", "frames_misfiled",
                                                          "captured_in_window"}
