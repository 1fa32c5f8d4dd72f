"""The mesh's compiled programs on the card (``parallel/programs.py``):
the sharded step replayed against the eager sharded step it captured, bit
for bit, with the same kernel launches and staged bytes a frame; the flat
and the propagated reseed and the TV-L1 with its gather, each called twice
(the second a replay), against their eager functions, bit for bit; at
(1, 1, 1) also the step against the single engine's replay, bit for bit.
The form of every program follows the backend: with a card per rank
(NCCL) each is one graph with its collectives captured inside and no
exchange point, the same on every rank; four ranks sharing one card (gloo)
run graph segments with the exchanges between them; a one-rank world is
one graph either way.

``cuda``-marked: they need a GPU with nvcc and skip elsewhere. The file
imports no JAX, so it runs on the card with ``--noconftest``; the NCCL
cases need four cards on one machine.
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
    new = frames[4]
    reseed = (new.image, new.T_world_curr.astype(np.float32), _bounds(new))
    return arrays, [(fr.image, _Tcw(fr)) for fr in frames[3:9]], reseed


def _assert_equal(got, want):
    for name in want:
        if name == "scene":
            for k in want[name]:
                np.testing.assert_array_equal(got[name][k], want[name][k], err_msg=k)
        else:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 2, 2), (2, 1, 2)])
def test_sharded_replay_matches_eager(scene, shape):
    arrays, frames, (img, T_world_ref, bounds) = scene
    todo = {
        "steps": ("graphs_vs_eager", (arrays, CFG, CAM, frames, shape == (1, 1, 1))),
        "reseed": ("programs_reseed_denoise", (arrays, CFG, CAM, 1, img, T_world_ref, bounds,
                                               0.5)),
    }
    out = run_ranks(torch_mesh_cases.jobs, shape, (todo,), device="cuda", timeout=600)
    # a card per rank: NCCL; ranks sharing a card: gloo
    backend = "nccl" if len(out) <= torch.cuda.device_count() else "gloo"
    for r in out:
        steps, reseed = r["steps"], r["reseed"]
        assert steps["backend"] == backend
        for i, f in enumerate(steps["frames"]):
            _assert_equal(f["programs"], f["eager"])
            np.testing.assert_array_equal(f["packed"], f["eager_packed"])
            # the warm-up, then replays: the eager frame's launches and staged bytes
            assert f["counts"] == f["eager_counts"], (i, f["counts"], f["eager_counts"])
        (label, (graphs, exchanges, replays)), = steps["programs"].items()
        assert replays == len(frames) - 1
        if shape == (1, 1, 1):
            for f in steps["frames"]:
                for name in ("mu", "sigma_sq", "a", "b", "conv"):
                    np.testing.assert_array_equal(f["programs"][name][0], f["single"][name],
                                                  err_msg=name)
        for kind in ("flat", "propagated"):
            for got in reseed[kind]["programs"]:     # the first call and the replay
                _assert_equal(got, reseed[kind]["eager"])
        den = reseed["denoise"]
        for got in den["programs"]:
            np.testing.assert_array_equal(got, den["eager"])
        for got in den["gathered"]:
            np.testing.assert_array_equal(got, den["eager_gathered"])
        forms = [(f"step {label}", (graphs, exchanges, len(steps["collectives"][label]),
                                    replays))]
        forms += [(f"{kind} {lab}", form) for kind in ("flat", "propagated", "denoise")
                  for lab, form in reseed[kind]["forms"].items()]
        for lab, (graphs, exchanges, collectives, replays) in forms:
            assert replays >= 1, lab
            if backend == "nccl" or shape == (1, 1, 1):
                # one graph, its collectives captured inside
                assert (graphs, exchanges) == (1, 0), (lab, graphs, exchanges)
            else:
                assert exchanges == collectives and graphs == exchanges + 1, (
                    lab, graphs, exchanges, collectives)
        if shape != (1, 1, 1):
            # every step and denoise program met collectives
            assert all(steps["collectives"].values()) and all(
                form[2] > 0 for form in den["forms"].values()), (steps, den["forms"])
    if shape != (1, 1, 1):
        # the same on every rank
        assert len({str(r["steps"]["programs"]) for r in out}) == 1
        assert len({str(r["steps"]["collectives"]) for r in out}) == 1
        assert len({str(r["reseed"]["denoise"]["forms"]) for r in out}) == 1
