"""The traffic generator: ping-pong stream order, the trajectory's poses
and the frame bank drawn from the seed."""

import numpy as np
import pytest

from benchmark import synth

SCENE = {"noise_sigma": 0.01, "vignette": 0.15, "n_textureless": 3, "n_spheres": 2}
CAM = {"width": 64, "height": 48, "fx": 48.12, "fy": -48.0, "cx": 31.5, "cy": 23.5}


def test_ping_pong_plays_there_and_back():
    assert [synth.ping_pong(t, 4) for t in range(10)] == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3]
    assert [synth.ping_pong(t, 1) for t in range(3)] == [0, 0, 0]
    seq = [synth.ping_pong(t, 120) for t in range(1000)]
    assert all(abs(a - b) == 1 for a, b in zip(seq, seq[1:]))


def test_trajectory_is_a_centred_lateral_dolly():
    T = synth.trajectory(120, 0.023, "lateral")
    assert T.shape == (120, 3, 4)
    x = T[:, 0, 3]
    assert np.allclose(np.diff(x), 0.023) and x[60] == 0.0
    R = T[:, :, :3]
    assert np.allclose(R @ np.swapaxes(R, 1, 2), np.eye(3), atol=1e-12)
    Tcw = synth.curr_world(T)
    back = Tcw[:, :, :3] @ T[:, :, 3:] + Tcw[:, :, 3:]
    assert np.abs(back).max() < 1e-6


def test_bank_is_drawn_from_the_seed():
    a = synth.render_bank(CAM, SCENE, 4, 0.023, "lateral", 2**31 + 11, "cpu")
    b = synth.render_bank(CAM, SCENE, 4, 0.023, "lateral", 2**31 + 11, "cpu")
    c = synth.render_bank(CAM, SCENE, 4, 0.023, "lateral", 2**31 + 12, "cpu")
    assert a.images.dtype == np.uint8 and a.images.shape == (4, 48, 64)
    assert np.array_equal(a.images, b.images) and not np.array_equal(a.images, c.images)
    # the seed draws texture and noise, not the poses
    assert np.array_equal(a.poses, c.poses)
    assert a.images.std() > 10
    lo, hi = a.bounds[:, 0], a.bounds[:, 1]
    assert np.all((0.5 < lo) & (lo < hi) & (hi < 5.0))


def test_unknown_motion_is_refused():
    with pytest.raises(ValueError):
        synth.trajectory(3, 0.023, "spiral")


def test_forward_bank_takes_the_plane_sweep():
    """Over every (reference, update) pair of the forward mix's ping-pong
    stream at the cell's own camera, nearly every update takes the plane
    sweep; the rest, an update on its own reference frame at the turn,
    the pure-rotation branch."""
    from benchmark import harness
    from benchmark.reference import match
    from benchmark.reference.config import Config

    cell = harness.load_cell("over_table_640.forward")
    cam, tr = cell.config["camera"], cell.traffic
    bank = synth.render_bank(cam, cell.config["scene"], tr["bank_frames"], tr["step_m"],
                             tr["motion"], 2**31 + 13, "cpu")
    z = synth.trajectory(tr["bank_frames"], tr["step_m"], tr["motion"])[:, 2, 3]
    assert z.min() == pytest.approx(-0.299) and z.max() == pytest.approx(0.276)
    regimes = [g for g, _, _ in harness.stream_regimes(bank, Config(), cam)]
    assert set(regimes) == {match.PLANE_SWEEP, match.PURE_ROTATION}
    share = regimes.count(match.PLANE_SWEEP) / len(regimes)
    assert share >= 0.8 and share == pytest.approx(0.98)
