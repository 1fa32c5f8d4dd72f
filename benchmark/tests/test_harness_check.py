"""What decides ``correct``, on the CPU at a small size: the frozen
reference recomputes the program's keyframes bit for bit; a sound run is
correct; a run with its timed path broken underneath is not, once for each
fault the cells can have."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import check, harness
from benchmark.reference import match as ref_match
from benchmark.tests.tiny import tiny_cell

torch.set_num_threads(2)
SEED = 2**31 + 5
CLOSED = ["over_table_640.offline", "over_table_640.forward"]   # lateral, axial motion


@pytest.mark.parametrize("workload, motion, regime", [
    ("over_table_640.offline", "lateral", ref_match.RECTIFIED),
    ("over_table_640.forward", "forward", ref_match.PLANE_SWEEP)])
def test_reference_replays_the_program_bit_for_bit(workload, motion, regime):
    """Each update of the motion takes the matcher ``regime`` (the lateral
    dolly the rectified sweep, the axial one the plane sweep), and the
    reference's keyframe equals the program's plain one."""
    import rpg_open_remode_tpu_torch as R

    from benchmark import synth
    from benchmark.reference import engine
    from benchmark.reference.config import Config

    cell = tiny_cell(workload)
    cam, scene = cell.config["camera"], cell.config["scene"]
    bank = synth.render_bank(cam, scene, 12, 0.0115, motion, SEED, "cpu")
    eng = R.Depthmap(cam["width"], cam["height"], cam["fx"], cam["cx"], cam["fy"], cam["cy"],
                     cfg=R.RemodeConfig(), device="cpu")
    eng.set_reference_image(bank.images[0], bank.poses[0], *map(float, bank.bounds[0]))
    T_ref, avg = eng.state.T_world_ref.numpy(), np.float32(eng.state.scene.avg_depth)
    for i in range(1, 12):
        assert ref_match.regime_index(bank.poses[i], T_ref, avg, np.float32(cam["fx"]),
                                      np.float32(cam["fy"]), cam["height"], cam["width"],
                                      Config()) == regime
        eng.update(bank.images[i], bank.poses[i])
    st, den = engine.replay_keyframe(bank.images, bank.poses, bank.bounds, list(range(12)),
                                     engine.Camera(**cam), Config(), "cpu")
    got = eng.state
    for f in ("mu", "sigma_sq", "a", "b", "conv", "match_u", "match_v"):
        assert torch.equal(getattr(got, f), getattr(st, f)), f
    assert np.array_equal(eng.denoised_depthmap(0.5, 200), den.numpy())
    # the filter moved: most seeds left the flat prior
    assert float((st.mu != st.scene.avg_depth).float().mean()) > 0.5


def test_misfiled_counts_frames_against_the_stream():
    assert check.misfiled([0, 10, 20], 29, [9, 9, 9]) == 0
    assert check.misfiled([0, 10, 20], 29, [9, 9]) == 0      # the last still open
    assert check.misfiled([0, 10, 20], 29, [9, 8, 9]) == 1
    assert check.misfiled([0, 10, 20], 29, [9]) == 10        # a keyframe lost
    assert check.misfiled([0, 10], 19, [9, 9, 4]) == 5       # one too many


def _policy(drains=(), n=None):
    return check.SwitchPolicy(stride=3, ref_compl_perc=10.0, max_dist=0.5, npx=100,
                              drains=drains, n=n)


def _ends(policy, converged, dist=None):
    """The update at which ``policy`` ends a keyframe whose update c has
    ``converged[c - 1]`` seeds converged (distance ``dist[c - 1]``)."""
    dist = dist or [0.0] * len(converged)
    for c in range(1, len(converged) + 1):
        if policy.decide(c, converged[c - 1], dist[c - 1]):
            break
    return policy.at


def test_switch_policy_reads_every_stride_one_stride_late():
    rising = list(range(1, 31))                 # over 10 % from update 11 on
    assert _ends(_policy(), rising) == 15       # read at 12, acted on at 15
    # the distance alone: over 0.5 m from update 8 on, read at 9
    assert _ends(_policy(), [0] * 30, [0.07 * c for c in range(1, 31)]) == 12
    # a flush reads the newest strided stats at once
    assert _ends(_policy(drains=[13]), rising) == 13
    assert _ends(_policy(drains=[12]), rising) == 12
    # a flush that finds no switch changes nothing
    assert _ends(_policy(drains=[10]), rising) == 15
    assert _ends(_policy(), [0] * 30) is None
    # on a replayed state: the replay stops only where the keyframe ended
    # before the program's own last update
    st = SimpleNamespace(conv=torch.zeros(100, dtype=torch.int32))
    p = _policy(n=20)
    assert not any(p(c, st, 0.0) for c in range(1, 21)) and p.at is None
    st.conv[:20] = check.CONVERGED
    p = _policy(n=15)
    assert [p(c, st, 0.0) for c in range(1, 7)] == [False] * 5 + [True] and p.at == 6
    p = _policy(n=6)
    assert [p(c, st, 0.0) for c in range(1, 7)] == [False] * 6 and p.at == 6


def test_verdict_needs_every_number_within_its_limit():
    ok, table = check.verdict({"a": 0.0, "b": 1.0}, {"a": 0.0, "b": 2.0})
    assert ok and table["b"] == {"value": 1.0, "limit": 2.0}
    assert not check.verdict({"a": float("nan")}, {"a": 1.0})[0]
    assert not check.verdict({"a": 0.5}, {"a": 0.1})[0]


def run(workload=CLOSED[0]):
    """A window of 24 frames: three keyframes of the tiny cell's ~8."""
    return harness.run_cell(tiny_cell(workload), SEED, None, False, "cpu", frames=24)


def verdict(ctx):
    return check.verdict(ctx["numbers"], ctx["cell"].config["limits"])


@pytest.mark.parametrize("workload", CLOSED)
def test_sound_run_is_correct(workload):
    ctx = run(workload)
    ok, table = verdict(ctx)
    assert ok, table
    assert ctx["outputs"] and ctx["window"].fed > 0
    assert all(t["value"] == 0.0 for t in table.values())


def _frozen_step(self, dtype, grid, regime):
    from rpg_open_remode_tpu_torch.models import depthmap as dm

    def body():   # the stats of a step, the state left as it was
        _, stats = dm.update_step(self.state, self._image(dtype, grid), self.inputs.pose,
                                  self.cam, self.cfg, regime)
        self.packed.copy_(stats["packed"])
    return body


def _altered_answer(denoise):
    def altered(*args, **kwargs):   # a band of the depth map half again too far
        out = denoise(*args, **kwargs).clone()
        out[: out.shape[0] // 6] *= 1.5
        return out
    return altered


def _dropping(process_frame):
    seen = {"n": 0}

    def every_other(self, image, T, min_depth=None, max_depth=None):
        seen["n"] += 1
        if seen["n"] % 2 == 0 and self.state.name == "UPDATE":
            return {"event": "updated"}
        return process_frame(self, image, T, min_depth, max_depth)
    return every_other


def _switching(resolve, drain, scale, flushed_only):
    """The switch policy with its thresholds ``scale`` times too high, or
    (``flushed_only``) firing only when the stream is flushed."""
    def resolve_(self):
        if flushed_only and getattr(self, "flushing", False):
            return resolve(self)
        saved = self.cfg
        self.cfg = dataclasses.replace(saved, ref_compl_perc=saved.ref_compl_perc * scale,
                                       max_dist_from_ref=saved.max_dist_from_ref * scale)
        try:
            return resolve(self)
        finally:
            self.cfg = saved

    def drain_(self):
        self.flushing = True
        try:
            return drain(self)
        finally:
            self.flushing = False
    return resolve_, drain_


FAULTS = ["state unchanged", "answer altered", "half the frames left out", "switch late",
          "switch never"]


@pytest.mark.parametrize("workload", CLOSED)
@pytest.mark.parametrize("fault", FAULTS)
def test_broken_timed_path_is_not_correct(monkeypatch, fault, workload):
    from rpg_open_remode_tpu_torch.models import node, programs

    if fault == "state unchanged":
        monkeypatch.setattr(programs.Programs, "_update", _frozen_step)
    elif fault == "answer altered":
        monkeypatch.setattr(node, "denoise_depthmap", _altered_answer(node.denoise_depthmap))
    elif fault == "half the frames left out":
        monkeypatch.setattr(node.DepthmapNode, "process_frame",
                            _dropping(node.DepthmapNode.process_frame))
    else:
        never = fault == "switch never"
        resolve_, drain_ = _switching(node.DepthmapNode._resolve_oldest,
                                      node.DepthmapNode.drain,
                                      float("inf") if never else 2.0, never)
        monkeypatch.setattr(node.DepthmapNode, "_resolve_oldest", resolve_)
        monkeypatch.setattr(node.DepthmapNode, "drain", drain_)
    ctx = run(workload)
    ok, table = verdict(ctx)
    assert not ok, table
    if fault.startswith("switch"):
        # the leaves the program delivered still equal the reference's:
        # only the policy's number catches it
        assert table["switches_off"]["value"] > 0, table
