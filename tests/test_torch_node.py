"""The port's keyframe lifecycle (``models/node.py``) and CLI against the
JAX package's.

The node runs the JAX ``TestNode`` scene (tests/test_io.py: 160x120, seed 3,
56 frames, ``num_planes=64``, ``ref_compl_perc=4``, ``max_dist_from_ref=0.45``,
``denoise_iters=30``) beside the JAX node. The CLI runs as a subprocess with
``--device cpu``, as tests/test_io.py's ``TestCLI`` runs the JAX CLI.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rpg_open_remode_tpu as J
from rpg_open_remode_tpu.models.node import DepthmapNode as JNode
from rpg_open_remode_tpu.utils import synthetic
import rpg_open_remode_tpu_torch as P
from rpg_open_remode_tpu_torch import cli
from rpg_open_remode_tpu_torch.io import load_state
from rpg_open_remode_tpu_torch.models.node import DepthmapNode as PNode
from torch_parity import jax_state_numpy

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
GOLD = ROOT / "tests" / "data" / "golden_dataset"
CAM = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)


def _Tcw(fr):
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


def _engine(pkg, cfg, **kw):
    return pkg.Depthmap(160, 120, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"], cfg=cfg, **kw)


def _drive(node, frames):
    """Feed every frame with its own depth bounds; returns the frames at
    which the node took a reference or completed a keyframe."""
    events = []
    for i, fr in enumerate(frames):
        d = fr.depth[np.isfinite(fr.depth)]
        ev = node.process_frame(fr.image, _Tcw(fr), float(d.min()), float(d.max()))["event"]
        if ev != "updated":
            events.append((i, ev))
    node.close()
    return events


@pytest.fixture(scope="module")
def lifecycle():
    frames = synthetic.generate(n_frames=56, width=160, height=120, cam=CAM, seed=3)
    out = {}
    for name, pkg, node_cls, kw in (("jax", J, JNode, {}), ("port", P, PNode, {"device": "cpu"})):
        cfg = pkg.RemodeConfig(num_planes=64, ref_compl_perc=4.0, max_dist_from_ref=0.45,
                               denoise_iters=30)
        exported = []
        node = node_cls(_engine(pkg, cfg, **kw), cfg=cfg, on_keyframe=exported.append)
        out[name] = dict(events=_drive(node, frames), node=node, exported=exported)
    return out


def test_node_switches_on_the_same_frames(lifecycle):
    j, p = lifecycle["jax"], lifecycle["port"]
    assert p["events"] == j["events"]
    assert sum(ev == "keyframe_complete" for _, ev in p["events"]) >= 1
    assert len(p["node"].keyframes) == len(j["node"].keyframes) >= 2
    assert p["exported"] == p["node"].keyframes
    for kp, kj in zip(p["node"].keyframes, j["node"].keyframes):
        assert kp.n_updates == kj.n_updates
        assert abs(kp.converged_percentage - kj.converged_percentage) <= 0.1


def test_node_metrics_rows_match_jax(lifecycle):
    """The per-frame NDJSON rows: the same frames, events and counts."""
    rows_p = lifecycle["port"]["node"].metrics.rows
    rows_j = lifecycle["jax"]["node"].metrics.rows
    assert [(r["frame"], r["event"]) for r in rows_p] == [(r["frame"], r["event"]) for r in rows_j]
    for rp, rj in zip(rows_p, rows_j):
        assert set(rp) == set(rj)
        assert abs(rp["converged"] - rj["converged"]) <= 0.001 * 160 * 120
        assert rp["dist_from_ref"] == pytest.approx(rj["dist_from_ref"], rel=1e-5)


def test_node_keyframes_match_jax(lifecycle):
    """Each finished keyframe's denoised depth, where both conv maps agree:
    within rtol 1e-4 on >= 0.99 of the pixels and within 1e-2 on all. The
    two packages' posteriors differ by float32 rounding after 24-30 updates,
    and 30 TV-L1 iterations spread each difference over its neighbours
    (tests/test_torch_depthmap.py bounds the whole-run denoise by quantile
    for the same reason): the two keyframes read 0.9949 and 0.9946 of the
    pixels within 1e-4 and a largest relative difference of 1.9e-3 and
    2.5e-3. The node's own finalization is held on every pixel by
    test_node_finalizes_carried_keyframes_as_jax."""
    for kp, kj in zip(lifecycle["port"]["node"].keyframes, lifecycle["jax"]["node"].keyframes):
        conv_p, conv_j = kp.state.conv.numpy(), np.asarray(kj.state.conv)
        agree = conv_p == conv_j
        assert agree.mean() >= 0.999
        assert np.isfinite(kp.denoised_depth).all()
        rel = np.abs(kp.denoised_depth - kj.denoised_depth) / np.abs(kj.denoised_depth)
        assert np.mean(rel[agree] <= 1e-4) >= 0.99, np.mean(rel[agree] <= 1e-4)
        assert rel[agree].max() <= 1e-2, rel[agree].max()


def test_node_finalizes_carried_keyframes_as_jax(lifecycle):
    """Each JAX keyframe's frozen state, carried across, goes through the
    port node's finalization (TV-L1 on the worker thread, download,
    ``on_keyframe``): its denoised depth equals the JAX node's within rtol
    1e-4 on every pixel, and the result carries the state and counts."""
    cfg = P.RemodeConfig(num_planes=64, ref_compl_perc=4.0, max_dist_from_ref=0.45,
                         denoise_iters=30)
    exported = []
    node = PNode(_engine(P, cfg, device="cpu"), cfg=cfg, on_keyframe=exported.append)
    jax_kfs = lifecycle["jax"]["node"].keyframes
    for kj in jax_kfs:
        node.engine.restore(P.state_from_numpy(jax_state_numpy(kj.state), device="cpu"))
        node._n_updates = kj.n_updates
        node._finalize_keyframe(kj.converged_percentage)
    node.close()
    assert exported == node.keyframes and len(exported) == len(jax_kfs)
    for kp, kj in zip(exported, jax_kfs):
        assert (kp.n_updates, kp.converged_percentage) == (kj.n_updates, kj.converged_percentage)
        np.testing.assert_array_equal(kp.state.mu.numpy(), np.asarray(kj.state.mu))
        np.testing.assert_allclose(kp.denoised_depth, np.asarray(kj.denoised_depth), rtol=1e-4)


def _small(cfg_kw):
    frames = synthetic.generate(n_frames=13, width=160, height=120, cam=CAM, seed=5)
    return frames, P.RemodeConfig(num_planes=48, **cfg_kw)


def test_node_publishes_convergence_every_n():
    """13 messages at a cadence of 4 publish at messages 4, 8 and 12
    (depthmap_node.cpp:158-162), each the overlay of that frame's state."""
    frames, cfg = _small(dict(publish_conv_every_n=4, max_dist_from_ref=100.0,
                              ref_compl_perc=101.0))
    overlays = []
    node = PNode(_engine(P, cfg, device="cpu"), cfg=cfg, on_convergence=overlays.append)
    d0 = frames[0].depth[np.isfinite(frames[0].depth)]
    for fr in frames:
        node.process_frame(fr.image, _Tcw(fr), float(d0.min()), float(d0.max()))
    node.close()
    assert len(overlays) == 3
    assert overlays[0].shape == (120, 160, 3) and overlays[0].dtype == np.uint8
    assert not node.keyframes


def test_worker_exception_reraised_at_close():
    frames, cfg = _small(dict(max_dist_from_ref=0.0))

    def boom(result):
        raise RuntimeError("export failed")

    node = PNode(_engine(P, cfg, device="cpu"), cfg=cfg, on_keyframe=boom)
    d0 = frames[0].depth[np.isfinite(frames[0].depth)]
    # one switch, resolved at update 12 from update 6's stats; no later
    # submission prunes the failed task before close()
    for fr in frames:
        node.process_frame(fr.image, _Tcw(fr), float(d0.min()), float(d0.max()))
    with pytest.raises(RuntimeError, match="export failed"):
        node.close()


def _cli(args, **kw):
    # The child gets the thread count this module sets for itself: at the
    # default (one thread a core) beside the other test workers, OpenMP
    # oversubscribes the cores and a 10 s run takes minutes.
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "rpg_open_remode_tpu_torch.cli", *args],
                          capture_output=True, text=True, timeout=600, cwd=ROOT, env=env, **kw)


def test_cli_run_synthetic_propagate_checkpoint(tmp_path):
    out = tmp_path / "out"
    r = _cli(["--device", "cpu", "run", "--synthetic", "--frames", "25", "--width", "128",
              "--height", "96", "--fx", "96.0", "--fy", "-95.0", "--propagate",
              "--checkpoint", "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "processed 25 frames" in r.stdout
    stems = sorted(p.name[:-len("_depth.npy")] for p in out.glob("kf_*_depth.npy"))
    assert stems, list(out.iterdir())
    for stem in stems:
        for suffix in ("_cloud.ply", "_convergence.png", "_state.npz"):
            assert (out / (stem + suffix)).is_file(), stem + suffix
        state = load_state(str(out / (stem + "_state.npz")), device="cpu")
        assert state.shape == (96, 128)
        assert np.load(out / (stem + "_depth.npy")).shape == (96, 128)
    assert (out / "global_map.ply").is_file()


def test_cli_run_stdin_stream(tmp_path):
    """Frames piped as '<path> tx ty tz qx qy qz qw min max' lines; the
    golden dataset's malformed lines are skipped."""
    lines = []
    for ln in open(GOLD / "first_2_frames_sequence.txt"):
        p = ln.split()
        if not p:
            continue
        img = GOLD / "images" / p[0]
        if img.exists() and len(p) >= 8:
            lines.append(" ".join([str(img)] + p[1:8] + ["0.5", "3.0"]))
        else:
            lines.append(ln.rstrip())
    r = _cli(["--device", "cpu", "run", "--stdin", "--width", "8", "--height", "6",
              "--fx", "6.0", "--fy", "-6.0", "--out", str(tmp_path / "out")],
             input="\n".join(lines) + "\n")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "processed 3 frames" in r.stdout, r.stdout
    assert "skipping malformed line" in r.stdout


def test_cli_bench_synthetic():
    r = _cli(["--device", "cpu", "bench", "--synthetic", "--frames", "12", "--width", "128",
              "--height", "96", "--fx", "96.0", "--fy", "-95.0"])
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["frames"] == 10
    assert out["mean_update_s"] > 0 and out["denoise_200it_s"] > 0
    assert 0.0 <= out["converged_percent"] <= 100.0


def test_cli_bench_config_is_the_jax_benchs(monkeypatch, capsys):
    """``bench --propagate`` at fx 962.4 builds the JAX bench's engine
    config, ``for_camera(fx)`` (patch 9, 255 planes, disp_pad 256):
    ``--propagate`` changes nothing in a one-keyframe bench, as in the JAX
    CLI (rpg_open_remode_tpu/cli.py:327)."""
    import dataclasses

    from rpg_open_remode_tpu import cli as jcli
    from rpg_open_remode_tpu_torch.models import depthmap as pdepthmap

    seen = []
    init = pdepthmap.Depthmap.__init__

    def record(self, *args, **kw):
        init(self, *args, **kw)
        seen.append(self.cfg)

    monkeypatch.setattr(pdepthmap.Depthmap, "__init__", record)
    cli.main(["--device", "cpu", "bench", "--synthetic", "--frames", "3", "--width", "96",
              "--height", "72", "--fx", "962.4", "--fy", "-960.0", "--propagate"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu"
    want = jcli._make_engine((96, 72, 962.4, 47.5, -960.0, 35.5)).cfg
    assert len(seen) == 1
    assert dataclasses.asdict(seen[0]) == dataclasses.asdict(want)
    assert (seen[0].patch_side, seen[0].num_planes, seen[0].disp_pad) == (9, 255, 256)
    assert not seen[0].propagate_depth


@pytest.mark.parametrize("propagate", [False, True])
def test_cli_run_keyframes(tmp_path, propagate):
    """``run --keyframes 2`` drives the concurrent-keyframe ring: it
    finalizes keyframes and exports their files and the map."""
    out = tmp_path / "out"
    r = _cli(["--device", "cpu", "run", "--synthetic", "--frames", "16", "--width", "96",
              "--height", "72", "--fx", "72.0", "--fy", "-71.0", "--motion-step", "0.06",
              "--keyframes", "2", "--checkpoint", "--verbose", "--out", str(out)]
             + (["--propagate"] if propagate else []))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "processed 16 frames" in r.stdout and "% converged per slot" in r.stdout
    stems = sorted(p.name[:-len("_depth.npy")] for p in out.glob("kf_*_depth.npy"))
    assert stems, r.stdout
    for stem in stems:
        for suffix in ("_cloud.ply", "_convergence.png", "_state.npz"):
            assert (out / (stem + suffix)).is_file(), stem + suffix
        assert load_state(str(out / (stem + "_state.npz")), device="cpu").shape == (72, 96)
    assert (out / "global_map.ply").is_file()


@pytest.mark.parametrize("flags", [["--mesh", "1,1"], ["--distributed", "localhost:1"],
                                   ["--host-devices", "2"]])
def test_cli_refuses_unported_paths(flags, tmp_path):
    """The mesh is ported (``parallel/``); what it cannot run exits non-zero
    before any work: a mesh that is not KF,TY,TX, and the multi-host and
    host-device flags without ``--mesh``."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["--device", "cpu", "run", "--synthetic", "--frames", "2", *flags,
                  "--out", str(tmp_path / "out")])
    assert exc.value.code not in (0, None)
    assert "--mesh" in str(exc.value.code)
    assert not (tmp_path / "out").exists()


def test_cli_has_no_multiprocess_flags():
    """The multi-process flags belong to the mesh (``--mesh
    --distributed``): an argument error, never a silent single-process
    run."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["--device", "cpu", "run", "--synthetic", "--frames", "2",
                  "--nproc", "2", "--proc", "1"])
    assert exc.value.code not in (0, None)


def test_cli_device_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run", "--synthetic", "--frames", "2", "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)
