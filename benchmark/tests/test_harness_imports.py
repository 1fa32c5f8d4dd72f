"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(harness.HERE)
SOURCES = sorted(p for p in ROOT.rglob("*.py") if "tests" not in p.parts)
PROGRAM = "rpg_open_remode_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")) + [
    ROOT / "accounting.py", ROOT / "synth.py", ROOT / "check.py", ROOT / "stats.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)


def test_whole_name_comparison():
    import sys

    saved = dict(sys.modules)
    try:
        sys.modules["rpg_open_remode_tpu_torch_fake"] = object()
        assert harness.forbidden_modules() == []
        sys.modules["rpg_open_remode_tpu.config"] = object()
        assert harness.forbidden_modules() == ["rpg_open_remode_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_run_prints_no_result_once_a_metric_reader_loaded_jax(monkeypatch, capsys):
    """The look at ``sys.modules`` comes after the metric readers have been
    loaded, so a module that one of them pulls in is seen."""
    import sys

    import torch

    from benchmark import run

    monkeypatch.setattr(run, "_caches", lambda: None)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {})

    def result(ctx, trace):   # a reader whose import loads JAX
        monkeypatch.setitem(sys.modules, "jax", object())
        return {"correct": True, "checks": {}}

    monkeypatch.setattr(harness, "result", result)
    rc = run.main(["--workload", "over_table_640.offline", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == "" and "jax" in captured.err
