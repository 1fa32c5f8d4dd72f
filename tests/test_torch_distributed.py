"""The port's ``run --mesh`` (``cli.py`` over ``parallel/``) as a user starts
it on the CPU: one process starting its gloo ranks, and two processes as two
hosts of one mesh (``--distributed``), each starting two ranks (the port's
tests/test_distributed.py: both hosts derive the same switches). Also: the
mesh never runs on the CPU unless asked to."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rpg_open_remode_tpu_torch import cli
from rpg_open_remode_tpu_torch.io import load_state
from rpg_open_remode_tpu_torch.parallel.launch import free_port

ROOT = Path(__file__).resolve().parent.parent
SCENE = ["--synthetic", "--width", "96", "--height", "72", "--fx", "72.0", "--fy", "-71.0",
         "--motion-step", "0.06"]


def _cli(args):
    return subprocess.Popen([sys.executable, "-m", "rpg_open_remode_tpu_torch.cli", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)


def _wait(procs, timeout=600):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _switches(stdout):
    return re.search(r"switches \(frame, slot\): (.*)", stdout).group(1)


def test_cli_mesh_on_cpu_ranks(tmp_path):
    """``--device cpu run --mesh 1,1,2 --host-devices 2``: two gloo ranks,
    the keyframes exported with their checkpoints and the map."""
    out = tmp_path / "out"
    p = _cli(["--device", "cpu", "run", *SCENE, "--frames", "14", "--mesh", "1,1,2",
              "--host-devices", "2", "--checkpoint", "--out", str(out)])
    (stdout, stderr), = _wait([p])
    assert p.returncode == 0, stderr[-3000:]
    assert "backend gloo; rank 0 -> cpu, rank 1 -> cpu" in stdout, stdout
    assert "processed 14 frames" in stdout
    stems = sorted(q.name[:-len("_depth.npy")] for q in out.glob("kf_*_depth.npy"))
    assert stems == [f"kf_{i:03d}" for i in range(len(stems))] and stems, stdout
    for stem in stems:
        for suffix in ("_cloud.ply", "_convergence.png"):
            assert (out / (stem + suffix)).is_file(), stem + suffix
        state = load_state(str(out / (stem + "_state.npz")), device="cpu")
        assert state.shape == (72, 96) and state.f_ref.shape == (3, 72, 96)
        assert np.isfinite(np.load(out / (stem + "_depth.npy"))).all()
    assert (out / "global_map.ply").is_file()


def test_cli_distributed_two_hosts(tmp_path):
    """Two processes, ``--distributed localhost:PORT --nproc 2 --proc I``, of
    a (2, 1, 2) mesh: each starts its two ranks (one keyframe row), both
    derive the same switches, and each writes the keyframes of its own row
    as ``kf_pI_NNN``."""
    coord = f"localhost:{free_port()}"
    outs = [tmp_path / f"h{i}" for i in range(2)]
    procs = [_cli(["--device", "cpu", "run", *SCENE, "--frames", "14", "--mesh", "2,1,2",
                   "--keyframes", "2", "--distributed", coord, "--nproc", "2", "--proc", str(i),
                   "--out", str(outs[i])]) for i in range(2)]
    results = _wait(procs)
    for i, (p, (stdout, stderr)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, f"host {i}:\n{stderr[-3000:]}"
        assert f"host {i} of 2, backend gloo; rank {2 * i} -> cpu, rank {2 * i + 1} -> cpu" \
            in stdout, stdout
    switches = [_switches(stdout) for stdout, _ in results]
    assert switches[0] == switches[1] != "[]", switches
    slots = [int(s) for s in re.findall(r"\(\d+, (\d+)\)", switches[0])]
    for i, out in enumerate(outs):
        mine = sorted(q.name for q in out.glob("kf_*_depth.npy"))
        assert mine == [f"kf_p{i}_{j:03d}_depth.npy" for j in range(slots.count(i))], mine
        assert (out / f"global_map_p{i}.ply").is_file() == bool(mine)


def test_cli_mesh_needs_cuda_by_default(monkeypatch, tmp_path):
    """Without ``--device cpu`` and without CUDA the mesh raises: it never
    runs on the CPU silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run", "--synthetic", "--frames", "2", "--mesh", "1,1,2",
                  "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("device, flags", [
    ("cuda", ["--mesh", "1,1,2", "--host-devices", "2"]),               # CPU ranks, CUDA asked
    ("cpu", ["--mesh", "1,1,2", "--host-devices", "3"]),                # not the mesh's ranks
    ("cpu", ["--mesh", "2,1,2", "--distributed", "localhost:1", "--nproc", "3", "--proc", "0"]),
    ("cpu", ["--mesh", "2,1,2", "--distributed", "localhost:1"]),       # no --nproc/--proc
    ("cpu", ["--mesh", "2,1,2", "--nproc", "2", "--proc", "0"]),        # no --distributed
])
def test_cli_refuses_inconsistent_mesh_flags(device, flags, tmp_path):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--device", device, "run", "--synthetic", "--frames", "2", *flags,
                  "--out", str(tmp_path / "out")])
    assert exc.value.code not in (0, None)
    assert not (tmp_path / "out").exists()


def test_mesh_layout_of_a_host():
    """Host I of P starts global ranks I * local .. I * local + local - 1."""
    args = cli.argparse.Namespace(mesh="2,2,2", distributed="h:1", nproc=2, proc=1)
    assert cli._mesh_layout(args) == ((2, 2, 2), 2, 4, 4, "h:1")
    args = cli.argparse.Namespace(mesh="1,2,2", distributed=None, nproc=None, proc=None)
    shape, hosts, first, local, coord = cli._mesh_layout(args)
    assert (shape, hosts, first, local) == ((1, 2, 2), 1, 0, 4)
    assert coord.startswith("localhost:") and int(coord.split(":")[1]) > 0
