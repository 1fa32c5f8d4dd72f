"""The mesh's compiled programs on the card (``parallel/programs.py``):
the sharded step replayed against the eager sharded step it captured, bit
for bit, with the same kernel launches and staged bytes a frame; at
(1, 1, 1) also against the single engine's replay, bit for bit, and as one
graph with no exchange point; at (1, 2, 2) as graph segments with the
exchanges between them: four ranks sharing one card over gloo, or, with
four cards, a card each over NCCL.

``cuda``-marked: they need a GPU with nvcc and skip elsewhere. The file
imports no JAX, so it runs on the card with ``--noconftest``.
"""

import numpy as np
import pytest
import torch

import rpg_open_remode_tpu_torch as P
from rpg_open_remode_tpu_torch.models.state import stack_states, state_to_numpy
from rpg_open_remode_tpu_torch.parallel import run_ranks
from rpg_open_remode_tpu_torch.utils import synthetic

import torch_mesh_cases

W, H = 160, 120
CAM = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)
CFG = dict(num_planes=48)


def _Tcw(fr):
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


def _bounds(fr):
    d = fr.depth[np.isfinite(fr.depth)]
    return float(d.min()), float(d.max())


@pytest.fixture(scope="module")
def scene():
    """Two keyframes (frames 0 and 2) seeded by the single engine on the
    card, as a batched numpy state, and six lateral frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    frames = synthetic.generate(n_frames=9, width=W, height=H, cam=CAM, seed=5)
    states = []
    for i in (0, 2):
        eng = P.Depthmap(W, H, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"],
                         cfg=P.RemodeConfig(**CFG))
        eng.set_reference_image(frames[i].image, _Tcw(frames[i]), *_bounds(frames[i]))
        states.append(eng.state)
    arrays = state_to_numpy(stack_states(states))
    return arrays, [(fr.image, _Tcw(fr)) for fr in frames[3:9]]


def _assert_equal(got, want):
    for name in want:
        if name == "scene":
            for k in want[name]:
                np.testing.assert_array_equal(got[name][k], want[name][k], err_msg=k)
        else:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 2, 2)])
def test_sharded_replay_matches_eager(scene, shape):
    arrays, frames = scene
    out = run_ranks(torch_mesh_cases.graphs_vs_eager, shape,
                    (arrays, CFG, CAM, frames, shape == (1, 1, 1)), device="cuda", timeout=600)
    # a card per rank: NCCL; ranks sharing a card: gloo
    backend = "nccl" if len(out) <= torch.cuda.device_count() else "gloo"
    for r in out:
        assert r["backend"] == backend
        for i, f in enumerate(r["frames"]):
            _assert_equal(f["programs"], f["eager"])
            np.testing.assert_array_equal(f["packed"], f["eager_packed"])
            # the warm-up, then replays: the eager frame's launches and staged bytes
            assert f["counts"] == f["eager_counts"], (i, f["counts"], f["eager_counts"])
        (label, (graphs, exchanges, replays)), = r["programs"].items()
        assert replays == len(frames) - 1
        if shape == (1, 1, 1):
            assert (graphs, exchanges) == (1, 0), label
            for f in r["frames"]:
                for name in ("mu", "sigma_sq", "a", "b", "conv"):
                    np.testing.assert_array_equal(f["programs"][name][0], f["single"][name],
                                                  err_msg=name)
        else:
            assert exchanges > 0 and graphs == exchanges + 1, (label, graphs, exchanges)
    if shape != (1, 1, 1):
        assert len({str(r["programs"]) for r in out}) == 1   # the same on every rank
