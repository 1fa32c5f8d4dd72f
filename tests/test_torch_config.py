"""The port's config against the JAX package's, and the port's import rule
(no JAX, nothing of the JAX package)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from rpg_open_remode_tpu import config as jcfg
from rpg_open_remode_tpu_torch import config as pcfg

torch.set_num_threads(2)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_defaults_equal_field_by_field():
    assert _fields(pcfg.RemodeConfig()) == _fields(jcfg.RemodeConfig())
    j, p = jcfg.RemodeConfig(), pcfg.RemodeConfig()
    for prop in ("patch_offset", "patch_area", "tv_sigma", "max_walk_steps"):
        assert getattr(p, prop) == getattr(j, prop), prop
    assert {s.name: int(s) for s in pcfg.ConvergenceState} == {
        s.name: int(s) for s in jcfg.ConvergenceState
    }


@pytest.mark.parametrize("fx", [481.2, 962.4, 1443.6])
def test_for_camera_equal_field_by_field(fx):
    p = pcfg.RemodeConfig.for_camera(fx)
    assert _fields(p) == _fields(jcfg.RemodeConfig.for_camera(fx))
    assert p.patch_offset == -(p.patch_side // 2)


def test_port_imports_no_jax():
    """Importing the port (its engine, the lifecycle, IO and CLI) loads no
    jax module and no module of the JAX package. The port's own name shares
    the prefix ``rpg_open_remode_tpu``, so the JAX package's modules are
    matched with the dot."""
    code = (
        "import sys, rpg_open_remode_tpu_torch as p\n"
        "from rpg_open_remode_tpu_torch.models import depthmap\n"
        "from rpg_open_remode_tpu_torch.ops import rect_match, sweep_cuda, denoise_cuda\n"
        "from rpg_open_remode_tpu_torch import cli, io, native\n"
        "from rpg_open_remode_tpu_torch.models import node\n"
        "from rpg_open_remode_tpu_torch.ops import propagate\n"
        "from rpg_open_remode_tpu_torch.utils import devices, profiling\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('jaxlib') or m == 'rpg_open_remode_tpu' "
        "or m.startswith('rpg_open_remode_tpu.')]\n"
        "assert not bad, bad\n"
        "import torch\nassert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok')\n"
    )
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py imports nothing of JAX or the JAX package, at its top
    level or inside its functions."""
    import ast

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    bad = {n for n in names if n.split(".")[0] in ("jax", "jaxlib", "rpg_open_remode_tpu")}
    assert not bad, bad
    assert "rpg_open_remode_tpu_torch" in {n.split(".")[0] for n in names}


def test_chip_smoke_fails_without_cuda_or_package(tmp_path):
    """Without CUDA, or run alone outside the repo, chip_smoke.py exits
    non-zero and prints no result line. CUDA is hidden from the child, so
    this holds on a machine with a GPU too."""
    import os

    root = Path(__file__).resolve().parent.parent
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((root / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for script, cwd in ((root / "chip_smoke.py", root), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
