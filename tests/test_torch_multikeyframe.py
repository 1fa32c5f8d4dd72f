"""The port's concurrent-keyframe ring (``models/multikeyframe.py``) against
the JAX package's, on the 160x120 scenes of
tests/test_io.py (``TestBatchedKeyframes``, ``TestMultiKeyframeNode``, the
stagger/stats collision) and tests/test_ring.py.

Tolerances: a ring slot equals a single port ``Depthmap`` fed alike bit for
bit (the slot runs the same ``update_step``). Against the JAX ring, after
5 updates, per slot: ``mu`` within rtol 1e-4 / atol 1e-5 and the conv map
equal, each on >= 0.999 of the pixels (ROADMAP's slice rule; as
tests/test_torch_depthmap.py, since a seed whose match flips on float32
rounding takes another measurement: 6 of 19,200 pixels here); the
propagated reseed of a carried-across slot: rtol 1e-4 / atol
1e-5 on mu, sigma_sq, a, b and the keyframe image (tests/test_ring.py).
"""

import numpy as np
import pytest
import torch

from rpg_open_remode_tpu.config import RemodeConfig as JConfig
from rpg_open_remode_tpu.models.multikeyframe import BatchedDepthmap as JRing
from rpg_open_remode_tpu.models.multikeyframe import MultiKeyframeNode as JNode
from rpg_open_remode_tpu.utils import synthetic
import rpg_open_remode_tpu_torch as P
from rpg_open_remode_tpu_torch.models.multikeyframe import BatchedDepthmap, MultiKeyframeNode
from torch_parity import jax_state_numpy

torch.set_num_threads(2)
CAM = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)
W, H = 160, 120
FIELDS = ("mu", "sigma_sq", "a", "b", "conv", "match_u", "match_v", "ref_img", "T_world_ref")


def _Tcw(fr):
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


def _bounds(fr):
    d = fr.depth[np.isfinite(fr.depth)]
    return float(d.min()), float(d.max())


def _port_ring(n, cfg):
    return BatchedDepthmap(n, W, H, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"], cfg=cfg,
                           device="cpu")


@pytest.fixture(scope="module")
def batched():
    """tests/test_io.py's batch: slots seeded on frames 0 and 2, updated on
    frames 3-7, in the JAX ring, the port's ring and two port engines."""
    frames = synthetic.generate(n_frames=10, width=W, height=H, cam=CAM, seed=5)
    jring = JRing(2, W, H, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"], cfg=JConfig(num_planes=48))
    cfg = P.RemodeConfig(num_planes=48)
    ring = _port_ring(2, cfg)
    singles = [P.Depthmap(W, H, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"], cfg=cfg,
                          device="cpu") for _ in range(2)]
    for slot, ref_idx in enumerate((0, 2)):
        f = frames[ref_idx]
        for r in (jring, ring):
            r.seed_keyframe(slot, f.image, _Tcw(f), *_bounds(f))
        singles[slot].set_reference_image(f.image, _Tcw(f), *_bounds(f))
    stats = []
    for fr in frames[3:8]:
        jring.update(fr.image, _Tcw(fr))
        got = ring.update(fr.image, _Tcw(fr))
        want = [eng.update(fr.image, _Tcw(fr)) for eng in singles]
        stats.append((got, want))
    return dict(jring=jring, ring=ring, singles=singles, stats=stats)


def test_ring_slot_equals_single_depthmap(batched):
    ring, singles = batched["ring"], batched["singles"]
    for slot, eng in enumerate(singles):
        got = ring.keyframe_state(slot)
        for name in FIELDS:
            assert torch.equal(getattr(got, name), getattr(eng.state, name)), (slot, name)
    for got, want in batched["stats"]:
        assert got["packed"].shape == (2, 7)
        for slot, st in enumerate(want):
            for k, v in st.items():
                assert torch.equal(got[k][slot], v), (slot, k)


def test_ring_matches_jax_ring(batched):
    ring, jring = batched["ring"], batched["jring"]
    for slot in range(2):
        got, want = ring.keyframe_state(slot), jring.keyframe_state(slot)
        mu, want_mu = got.mu.numpy(), np.asarray(want.mu)
        within = (np.abs(mu - want_mu) <= 1e-5 + 1e-4 * np.abs(want_mu)).mean()
        assert within >= 0.999, (slot, within)
        agree = (got.conv.numpy() == np.asarray(want.conv)).mean()
        assert agree >= 0.999, (slot, agree)
    np.testing.assert_allclose(ring.converged_fraction(), jring.converged_fraction(), atol=1e-3)
    stacked = ring.states
    assert stacked.mu.shape == (2, H, W) and stacked.scene.avg_depth.shape == (2,)


def test_states_from_numpy_carries_the_jax_ring(batched):
    jring = batched["jring"]
    slots = P.states_from_numpy(jax_state_numpy(jring.states), device="cpu")
    assert len(slots) == 2
    for slot, st in enumerate(slots):
        want = jring.keyframe_state(slot)
        np.testing.assert_array_equal(st.mu.numpy(), np.asarray(want.mu))
        np.testing.assert_array_equal(st.conv.numpy(), np.asarray(want.conv))
        assert float(st.scene.max_depth) == float(want.scene.max_depth)


def test_ring_propagated_reseed_matches_jax():
    """tests/test_ring.py's setup: a 2-slot propagating ring, 11 updates,
    then slot 0 reseeded from frame 12. The JAX ring's slots are carried
    across before the reseed, so the reseed alone is compared."""
    frames = synthetic.generate(n_frames=14, width=W, height=H, cam=CAM, seed=5)
    f0 = frames[0]
    bounds = _bounds(f0)
    jring = JRing(2, W, H, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"],
                  cfg=JConfig(num_planes=48, propagate_depth=True))
    for slot in range(2):
        jring.seed_keyframe(slot, f0.image, _Tcw(f0), *bounds)
    for fr in frames[1:12]:
        jring.update(fr.image, _Tcw(fr))
    ring = _port_ring(2, P.RemodeConfig(num_planes=48, propagate_depth=True))
    for slot, st in enumerate(P.states_from_numpy(jax_state_numpy(jring.states), device="cpu")):
        ring.restore(slot, st)
    kept = ring.keyframe_state(1)

    f12 = frames[12]
    jring.seed_keyframe(0, f12.image, _Tcw(f12), *bounds)
    ring.seed_keyframe(0, f12.image, _Tcw(f12), *bounds)
    got, want = ring.keyframe_state(0), jring.keyframe_state(0)
    for name in ("mu", "sigma_sq", "a", "b", "ref_img"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # the warm start carried depth, and slot 1 is untouched
    assert (np.abs(got.mu.numpy() - float(got.scene.avg_depth)) > 1e-3).any()
    # (keyframe_state hands out a copy: the slot's buffers hold the same)
    now = ring.keyframe_state(1)
    for name in ("mu", "sigma_sq", "a", "b", "conv", "ref_img", "T_world_ref"):
        assert torch.equal(getattr(now, name), getattr(kept, name)), name


def test_ring_hovering_camera_takes_pure_rotation():
    """tests/test_ring.py: an identical frame and pose fed 6 times. The
    regime dispatch routes the zero baseline through the pure-rotation
    matcher: no seed converges, depth stays put, textured interior seeds
    self-match."""
    frames = synthetic.generate(n_frames=2, width=W, height=H, cam=CAM, seed=5)
    f0 = frames[0]
    ring = _port_ring(2, P.RemodeConfig(num_planes=48))
    for slot in range(2):
        ring.seed_keyframe(slot, f0.image, _Tcw(f0), *_bounds(f0))
    mu_init = ring.states.mu.clone()
    for _ in range(6):
        ring.update(f0.image, _Tcw(f0))
    states = ring.states
    assert not (states.conv == int(P.ConvergenceState.CONVERGED)).any()
    assert torch.equal(states.mu, mu_init)
    yy, xx = np.mgrid[:H, :W]
    interior = np.zeros((H, W), bool)
    interior[8:-8, 8:-8] = True
    for slot in range(2):
        st = ring.keyframe_state(slot)
        cand = ((st.conv.numpy() == int(P.ConvergenceState.UPDATE)) & interior
                & (st.const_templ_denom.numpy() > 1e-4))
        assert cand.mean() > 0.5, cand.mean()
        err = np.hypot(st.match_u.numpy() - xx, st.match_v.numpy() - yy)[cand]
        assert np.percentile(err, 90) < 0.1


def _drive(node, frames, bounds=None):
    for fr in frames:
        node.process_frame(fr.image, _Tcw(fr), *(bounds or _bounds(fr)))
    node.close()


def test_node_matches_jax_node():
    """tests/test_io.py's lifecycle: 45 frames, 2 slots, stride 3, stagger
    8. The same keyframes with the same update counts; each finalized mu,
    where the two conv maps agree, within rtol 1e-4 on >= 0.995 of the
    pixels and within 5e-2 on all: after 22-24 updates a few seeds' matches
    flip on float32 rounding and take another measurement (readings 0.9986
    and 0.9989, largest relative differences 5.0e-3 and 2.1e-2), as in
    tests/test_torch_node.py."""
    frames = synthetic.generate(n_frames=45, width=W, height=H, cam=CAM, seed=5)
    bounds = _bounds(frames[0])
    jnode = JNode(JRing(2, W, H, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"],
                        cfg=JConfig(num_planes=48)), policy_stride=3, stagger=8)
    exported = []
    node = MultiKeyframeNode(_port_ring(2, P.RemodeConfig(num_planes=48)),
                             on_keyframe=exported.append, policy_stride=3, stagger=8)
    _drive(jnode, frames, bounds)
    _drive(node, frames, bounds)
    assert len(node.keyframes) == len(jnode.keyframes) >= 1
    assert exported == node.keyframes
    T0, T1 = (node.engine.keyframe_state(s).T_world_ref for s in range(2))
    assert not torch.allclose(T0, T1)
    for kp, kj in zip(node.keyframes, jnode.keyframes):
        assert kp.n_updates == kj.n_updates > 0
        assert abs(kp.converged_percentage - kj.converged_percentage) <= 0.1
        assert np.isfinite(kp.denoised_depth).all()
        agree = kp.state.conv.numpy() == np.asarray(kj.state.conv)
        assert agree.mean() >= 0.999
        rel = np.abs(kp.state.mu.numpy() - np.asarray(kj.state.mu))[agree] / np.abs(
            np.asarray(kj.state.mu)[agree])
        assert np.mean(rel <= 1e-4) >= 0.995, np.mean(rel <= 1e-4)
        assert rel.max() <= 5e-2, rel.max()


def test_node_stagger_stats_collision_no_junk_keyframes():
    """tests/test_io.py: with stagger == policy_stride every forced reseed
    lands on a stats dispatch; the generation snapshot is taken before the
    reseed, so no keyframe completes with zero updates."""
    frames = synthetic.generate(n_frames=30, width=W, height=H, cam=CAM, seed=5, step=0.08)
    node = MultiKeyframeNode(_port_ring(2, P.RemodeConfig(num_planes=48)),
                             policy_stride=6, stagger=6)
    _drive(node, frames, _bounds(frames[0]))
    assert node.keyframes
    assert all(r.n_updates > 0 for r in node.keyframes)


def test_node_reraises_worker_errors():
    frames = synthetic.generate(n_frames=14, width=W, height=H, cam=CAM, seed=5, step=0.08)

    def boom(result):
        raise RuntimeError("export failed")

    node = MultiKeyframeNode(_port_ring(2, P.RemodeConfig(num_planes=48)), on_keyframe=boom,
                             policy_stride=3)
    with pytest.raises(RuntimeError, match="export failed"):
        _drive(node, frames, _bounds(frames[0]))


def test_ring_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchedDepthmap(2, W, H, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"])
