"""The port's compiled programs (``models/programs.py``) and the two matcher
decisions they need without a host read, against the JAX package at
160x120.

* The regime: the host choice (``rect_match.regime_index``, numpy float32)
  equals the port's device index (``regime_device``) and the index the JAX
  matcher hands to ``lax.switch``, on every frame of the synthetic lateral
  and forward sequences and on seeded poses (identity, forward motion, and
  poses either side of each threshold).
* The coarse gate: ``prepare_sweep`` with the gate on the device against
  the JAX ``prepare_sweep`` (``lax.cond``) on a young keyframe (gate on)
  and an old one (gate off).
* The facade's program path on the CPU (the same function and copies a
  replay makes on the card) equals the eager functional chain bit for bit,
  through a flat and a propagated keyframe and through the undistortion
  path; ``update_chunk`` equals K updates and the JAX ``update_chunk``.
* A state handed out by ``Depthmap.state``, the node or a ring slot is a
  copy that later frames and keyframes leave unchanged.
* Launch accounting: a capture's record adds once per replay.
* The program cache's key.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpg_open_remode_tpu as J
import rpg_open_remode_tpu_torch as P
from rpg_open_remode_tpu import config as jcfg
from rpg_open_remode_tpu.models import state as jstate
from rpg_open_remode_tpu.ops import rect_match as jrect
from rpg_open_remode_tpu.ops import seed_check as jseed_check
from rpg_open_remode_tpu.ops import seed_init as jseed_init
from rpg_open_remode_tpu.utils import camera as jcamera
from rpg_open_remode_tpu.utils import se3 as jse3
from rpg_open_remode_tpu.utils import synthetic
from rpg_open_remode_tpu_torch import kernels
from rpg_open_remode_tpu_torch.models import depthmap as pdm
from rpg_open_remode_tpu_torch.models import programs
from rpg_open_remode_tpu_torch.models.multikeyframe import BatchedDepthmap
from rpg_open_remode_tpu_torch.models.node import DepthmapNode
from rpg_open_remode_tpu_torch.models.state import SceneParams, clone, empty_state
from rpg_open_remode_tpu_torch.ops import rect_match as prect
from rpg_open_remode_tpu_torch.ops import sweep_cuda
from rpg_open_remode_tpu_torch.utils import se3 as pse3
from rpg_open_remode_tpu_torch.utils import warp as pwarp
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera
from torch_parity import jax_state_numpy

torch.set_num_threads(2)
W, H = 160, 120
CAM = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)
HARDEN = dict(noise_sigma=0.01, vignette=0.15, n_textureless=3, n_spheres=2)


def _Tcw(fr):
    T = np.concatenate([fr.T_world_curr, [[0, 0, 0, 1]]])
    return np.linalg.inv(T)[:3].astype(np.float32)


def _bounds(fr):
    d = fr.depth[np.isfinite(fr.depth)]
    return float(d.min()), float(d.max())


def _engine(**kw):
    return P.Depthmap(W, H, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"], device="cpu", **kw)


def _leaves(state):
    out = P.state_to_numpy(state)
    scene = out.pop("scene")
    out.update({"scene." + k: v for k, v in scene.items()})
    return out


def _assert_states_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    for name in w:
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)


@pytest.fixture(scope="module")
def lateral():
    return synthetic.generate(n_frames=9, width=W, height=H, cam=CAM, seed=1, step=0.023,
                              **HARDEN)


@pytest.fixture(scope="module")
def forward():
    return synthetic.generate(n_frames=11, width=W, height=H, cam=CAM, seed=4,
                              motion="forward", step=0.046)


# -- the regime --------------------------------------------------------------


def _keyframe(T_curr_world, bounds, img=None):
    """A JAX keyframe state at pose ``T_curr_world`` (on ``img``, default
    black) and its port copy."""
    cfg = jcfg.RemodeConfig()
    img = np.zeros((H, W), np.float32) if img is None else img
    T_world_ref = np.asarray(jse3.inv(jnp.asarray(T_curr_world)))
    st = jseed_init.init_seeds(
        jstate.empty_state(H, W, jcamera.PinholeCamera.create(**CAM)), jnp.asarray(img),
        jnp.asarray(T_world_ref), jstate.SceneParams.create(*bounds, cfg), cfg)
    return st, P.state_from_numpy(jax_state_numpy(st))


def _jax_switch_index(jst, T_curr_ref, cfg, monkeypatch):
    """The index the JAX matcher hands to ``lax.switch`` (the switch itself
    is replaced by a recorder, so no branch runs)."""
    seen = []
    with monkeypatch.context() as m:
        m.setattr(jax.lax, "switch", lambda idx, branches, *ops: seen.append(int(idx)))
        jrect.match(jst, jnp.zeros((H, W), jnp.float32), jnp.asarray(T_curr_ref),
                    jcamera.PinholeCamera.create(**CAM), cfg)
    return seen[0]


def _seeded_poses():
    """(T_curr_ref, label): identity, forward motion, and poses a relative
    1e-3 either side of the zero-baseline threshold and of each epipole
    bound, some with a small seeded rotation."""
    rng = np.random.default_rng(11)
    avg = np.float32(1.0)
    thr = 1e-5 * avg + 1e-9
    m_x, m_y = 0.75 * W, 0.75 * H

    def pose(t, rot=0.0):
        w = rng.normal(size=3) * rot
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        R = np.eye(3) if th == 0 else (
            np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th ** 2 * K @ K)
        return np.concatenate([R, np.asarray(t, float)[:, None]], 1).astype(np.float32)

    out = [(pose([0, 0, 0]), "identity"), (pose([0, 0, 0.05]), "forward"),
           (pose([0.01, -0.004, 0.08], 0.01), "forward rotated")]
    for s in (1 - 1e-3, 1 + 1e-3):
        out.append((pose([thr * s, 0, 0]), f"baseline {s} x threshold"))
        out.append((pose([0, thr * s, 0]), f"baseline {s} x threshold, y"))
        tz = 0.05
        out.append((pose([m_x * tz / CAM["fx"] * s, 0, tz]), f"epipole x {s} x bound"))
        out.append((pose([0, m_y * tz / abs(CAM["fy"]) * s, tz]), f"epipole y {s} x bound"))
        out.append((pose([m_x * tz / CAM["fx"] * s, 0.001, tz], 1e-4),
                    f"epipole x {s} x bound, rotated"))
    for k in range(8):
        out.append((pose(rng.normal(size=3) * 0.05, 0.05), f"random {k}"))
    return out, avg


@pytest.mark.parametrize("case", ["lateral", "forward", "seeded"])
def test_host_regime_equals_device_and_jax(case, lateral, forward, monkeypatch):
    cfg_j, cfg_p = jcfg.RemodeConfig(), P.RemodeConfig()
    cam = PinholeCamera.create(**CAM)
    if case == "seeded":
        poses, avg = _seeded_poses()
        # a keyframe at the identity with mean depth avg: T_curr_ref is the
        # frame pose itself
        jst, pst = _keyframe(np.eye(4, dtype=np.float32)[:3], (avg - 0.5, avg + 0.5))
        frames = [(T, label) for T, label in poses]
    else:
        seq = lateral if case == "lateral" else forward
        jst, pst = _keyframe(_Tcw(seq[0]), _bounds(seq[0]))
        frames = [(_Tcw(fr), f"frame {i}") for i, fr in enumerate(seq)]
    T_ref = pst.T_world_ref.numpy()
    avg = pst.scene.avg_depth.numpy()
    seen = set()
    for T, label in frames:
        T_curr_ref = pse3.compose(torch.tensor(T), pst.T_world_ref)
        device = int(prect.regime_device(pst, T_curr_ref, cam, cfg_p, H, W))
        host = prect.regime_index(T, T_ref, avg, np.float32(CAM["fx"]), np.float32(CAM["fy"]),
                                  H, W, cfg_p)
        jax_idx = _jax_switch_index(jst, T_curr_ref.numpy(), cfg_j, monkeypatch)
        assert host == device == jax_idx, (label, host, device, jax_idx)
        seen.add(host)
    if case == "seeded":
        assert seen == {0, 1, 2}
    elif case == "forward":
        assert 1 in seen


# -- the coarse gate -----------------------------------------------------------


@pytest.mark.parametrize("age", ["young", "old"])
def test_device_gate_prepare_sweep_matches_jax(age, lateral):
    # frame 8: the first frames' baselines leave every band narrow
    fr0, fr = lateral[0], lateral[8]
    jst, _ = _keyframe(_Tcw(fr0), _bounds(fr0), fr0.image)
    cfg_j, cfg_p = jcfg.RemodeConfig(), P.RemodeConfig()
    if age == "old":
        # an old keyframe: every band narrowed to a few planes
        jst = dataclasses.replace(jst, sigma_sq=jst.sigma_sq * 1e-4)
    T = _Tcw(fr)
    jborder = jseed_check.border_mask(H, W, cfg_j)
    jconv = jseed_check.classify_seeds(jst.mu, jst.sigma_sq, jst.a, jst.b,
                                       jst.scene.epsilon, jborder, cfg_j)
    jst = dataclasses.replace(jst, conv=jconv)
    pst = P.state_from_numpy(jax_state_numpy(jst))
    jT = jse3.compose(jnp.asarray(T), jst.T_world_ref)
    want = jrect.prepare_sweep(jst, jnp.asarray(fr.image), jT,
                               jcamera.PinholeCamera.create(**CAM), cfg_j)
    pT = pse3.compose(torch.tensor(T), pst.T_world_ref)
    got = prect.prepare_sweep(pst, torch.tensor(fr.image), pT, PinholeCamera.create(**CAM),
                              cfg_p)
    assert got["gate"].dtype == torch.bool and got["gate"].dim() == 0
    assert bool(got["gate"]) == bool(want["wide_needed"]) == (age == "young")
    for key in ("disp_lo", "disp_hi"):
        g, w = got[key].numpy(), np.asarray(want[key])
        fin = np.isfinite(w)
        assert (np.isfinite(g) == fin).mean() >= 0.999, key
        both = fin & np.isfinite(g)
        close = np.abs(g[both] - w[both]) <= 1e-3 + 1e-4 * np.abs(w[both])
        assert close.mean() >= 0.995, (key, close.mean())


@pytest.mark.parametrize("gate", [True, False])
def test_plain_sweep_gate(gate):
    """A gate that is on changes nothing; one that is off gives the
    not-found result, on the CPU and by selection as on the card."""
    rng = np.random.default_rng(3)
    h, w, pad = 32, 64, 16
    args = (torch.tensor(rng.random((h, w + 2 * pad), dtype=np.float32)),
            torch.tensor(np.tile([[-5.0, w + 5.0]], (h, 1)).astype(np.float32)),
            torch.tensor(rng.random((h, w), dtype=np.float32)), torch.ones(h, w),
            torch.full((h, w), 2.0), torch.full((h, w), 9.0), 0.5, 12, pad, 5, True)
    ungated = sweep_cuda.disparity_sweep(*args)
    got = sweep_cuda.disparity_sweep(*args, gate=torch.tensor(gate))
    want = ungated if gate else sweep_cuda._not_found(args[2])
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


# -- the facade's programs against the eager chain -------------------------------


def _eager_chain(frames, cfg, cam, grid=None, uint8=False, switch_at=None):
    """set_reference on frames[0], update on the rest, a propagated reseed
    at ``switch_at``: the eager functional core, the regime read on the
    device."""
    def img_of(fr):
        x = torch.tensor(_img(fr, uint8))
        x = pdm.prep_image(x)
        return x if grid is None else pwarp.warp_grid(x, *grid)

    st = clone(empty_state(H, W, cam))
    scene = SceneParams.create(*_bounds(frames[0]), cfg)
    st = pdm.set_reference(st, img_of(frames[0]), torch.tensor(_Tcw(frames[0])), scene, cfg)
    packed = []
    for i, fr in enumerate(frames[1:], 1):
        if i == switch_at:
            scene = SceneParams.create(*_bounds(fr), cfg)
            st = pdm._set_reference_propagated(st, img_of(fr), torch.tensor(_Tcw(fr)), scene,
                                               cam, cfg)
            continue
        st, stats = pdm.update_step(st, img_of(fr), torch.tensor(_Tcw(fr)), cam, cfg)
        packed.append(stats["packed"])
    return st, packed


def _img(fr, uint8):
    return np.clip(fr.image * 255.0 + 0.5, 0, 255).astype(np.uint8) if uint8 else fr.image


@pytest.mark.parametrize("path", ["flat then propagated (uint8)", "undistorted (float)"])
def test_facade_programs_equal_eager_bit_for_bit(path, lateral):
    propagated = path.startswith("flat")
    cfg = P.RemodeConfig(propagate_depth=propagated)
    eng = _engine(cfg=cfg)
    grid = None
    if not propagated:
        eng.init_undistortion_map(-0.05, 0.01, 0.001, -0.0005)
        grid = eng._undistort_grid
    switch_at = 5 if propagated else None
    eng.set_reference_image(_img(lateral[0], propagated), _Tcw(lateral[0]),
                            *_bounds(lateral[0]))
    packed = []
    for i, fr in enumerate(lateral[1:], 1):
        if i == switch_at:
            eng.set_reference_image(_img(fr, True), _Tcw(fr), *_bounds(fr))
            continue
        packed.append(eng.update(_img(fr, propagated), _Tcw(fr))["packed"])
    want, want_packed = _eager_chain(lateral, eng.cfg, eng.cam, grid, propagated, switch_at)
    _assert_states_equal(eng.state, want)
    for g, w in zip(packed, want_packed):
        assert torch.equal(g, w)
    kinds = {key[0] for key in eng.programs.cache}
    assert kinds == ({"set_reference", "update", "set_reference_propagated"} if propagated
                     else {"set_reference", "update"})


@pytest.fixture(scope="module")
def jax_chunk(lateral):
    """The JAX facade: keyframe on frame 0 (its state carried to the port),
    then update_chunk of frames 1-4."""
    eng = J.Depthmap(W, H, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"])
    eng.set_reference_image(lateral[0].image, _Tcw(lateral[0]), *_bounds(lateral[0]))
    start = jax_state_numpy(eng.state)
    packed = eng.update_chunk(np.stack([fr.image for fr in lateral[1:5]]),
                              np.stack([_Tcw(fr) for fr in lateral[1:5]]))
    return start, jax_state_numpy(eng.state), np.asarray(packed)


def test_update_chunk_equals_updates_and_jax(lateral, jax_chunk):
    start, want_state, want_packed = jax_chunk
    a, b = _engine(), _engine()
    for eng in (a, b):
        eng.restore(P.state_from_numpy(start))
    rows = [a.update(fr.image, _Tcw(fr))["packed"] for fr in lateral[1:5]]
    packed = b.update_chunk(np.stack([fr.image for fr in lateral[1:5]]),
                            np.stack([_Tcw(fr) for fr in lateral[1:5]]))
    assert tuple(packed.shape) == (4, len(pdm.PACKED_STATS_KEYS))
    assert torch.equal(packed, torch.stack(rows))
    _assert_states_equal(b.state, a.state)

    got = P.state_to_numpy(b.state)
    assert np.mean(got["conv"] == want_state["conv"]) >= 0.999
    # four steps from one state: mu and a within 1e-4 as one step is held in
    # test_torch_depthmap; b = a (1 - f) / f and sigma_sq cancel terms, so
    # their float32 rounding grows over the steps (p99.9 ~3e-4 and ~5e-4)
    for name, rtol in (("mu", 1e-4), ("a", 1e-4), ("b", 1e-3), ("sigma_sq", 1e-3)):
        close = np.abs(got[name] - want_state[name]) <= rtol * np.abs(want_state[name])
        assert close.mean() >= 0.999, (name, close.mean())
    got_packed = packed.numpy()
    counts = slice(0, 5)
    assert np.abs(got_packed[:, counts] - want_packed[:, counts]).max() <= 1e-3 * W * H
    np.testing.assert_allclose(got_packed[:, 5], want_packed[:, 5], rtol=1e-5)
    np.testing.assert_allclose(got_packed[:, 6], want_packed[:, 6], atol=1e-3)


# -- states handed out are copies ------------------------------------------------


@pytest.mark.parametrize("holder", ["Depthmap.state", "DepthmapNode", "ring slot"])
def test_state_handed_out_is_unaliased(holder, lateral):
    cfg = P.RemodeConfig(propagate_depth=True)
    frames = lateral
    held = {}
    if holder == "Depthmap.state":
        eng = _engine(cfg=cfg)
        eng.set_reference_image(frames[0].image, _Tcw(frames[0]), *_bounds(frames[0]))
        eng.update(frames[1].image, _Tcw(frames[1]))
        held["state"] = eng.state
        held["copy"] = _leaves(held["state"])
        for fr in frames[2:4]:
            eng.update(fr.image, _Tcw(fr))
        eng.set_reference_image(frames[4].image, _Tcw(frames[4]), *_bounds(frames[4]))
        eng.update(frames[5].image, _Tcw(frames[5]))
    elif holder == "DepthmapNode":
        # every frame samples the stats; a distance limit ends each keyframe
        node_cfg = P.RemodeConfig(propagate_depth=True, max_dist_from_ref=0.03)

        def on_keyframe(result):
            if "state" not in held:
                held["state"] = result.state
                held["copy"] = _leaves(result.state)

        node = DepthmapNode(_engine(cfg=node_cfg), on_keyframe=on_keyframe, policy_stride=1)
        try:
            for fr in frames:
                node.process_frame(fr.image, _Tcw(fr), *_bounds(fr))
            node.flush()
        finally:
            node.close()
        assert len(node.keyframes) >= 1 and node.num_msgs == len(frames)
    else:
        ring = BatchedDepthmap(2, W, H, CAM["fx"], CAM["cx"], CAM["fy"], CAM["cy"], cfg=cfg,
                               device="cpu")
        for slot in range(2):
            ring.seed_keyframe(slot, frames[0].image, _Tcw(frames[0]), *_bounds(frames[0]))
        ring.update(frames[1].image, _Tcw(frames[1]))
        held["state"] = ring.keyframe_state(0)
        held["copy"] = _leaves(held["state"])
        for fr in frames[2:4]:
            ring.update(fr.image, _Tcw(fr))
        ring.seed_keyframe(0, frames[4].image, _Tcw(frames[4]), *_bounds(frames[4]))
        ring.update(frames[5].image, _Tcw(frames[5]))
    now = _leaves(held["state"])
    for name, v in held["copy"].items():
        np.testing.assert_array_equal(now[name], v, err_msg=name)


# -- launch accounting -----------------------------------------------------------


def test_replay_adds_recorded_launches_once_per_call():
    kernels.reset_launches()
    other = threading.Thread(target=lambda: kernels.count("tvl1", 7))
    with kernels.recording() as rec:
        kernels.count("sweep")
        kernels.count("warp", 3)
        other.start()
        other.join()
    # the capture's own launches are recorded, not counted; another
    # thread's launches during it are counted
    assert rec["sweep"] == 1 and rec["warp"] == 3 and rec["tvl1"] == 0
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0) | {"tvl1": 7}

    class Replayed:
        calls = 0

        def replay(self):
            Replayed.calls += 1

    prog = programs.Program(lambda: None, torch.device("cuda"), None, "test")
    prog.graph, prog.launches = Replayed(), rec
    for _ in range(3):
        prog()
    assert Replayed.calls == 3 and prog.replays == 3
    assert kernels.LAUNCHES["sweep"] == 3 and kernels.LAUNCHES["warp"] == 9
    assert kernels.LAUNCHES["tvl1"] == 7
    kernels.reset_launches()


def test_program_cache_keys_on_kind_dtype_grid_regime(lateral):
    """The engine's config is its programs' own, and its cache is keyed by
    (kind, input dtype, undistortion grid, regime): frames of one regime
    and dtype reuse one program, a float frame adds the float variant."""
    eng = _engine(cfg=P.RemodeConfig(ref_compl_perc=10.0))
    assert eng.cfg is eng.programs.cfg and eng.cfg.ref_compl_perc == 10.0
    eng.set_reference_image(_img(lateral[0], True), _Tcw(lateral[0]), *_bounds(lateral[0]))
    regimes = set()
    for fr in lateral[1:5]:
        regimes.add(eng.programs.regime(_Tcw(fr)))
        eng.update(_img(fr, True), _Tcw(fr))
    eng.update(_img(lateral[5], False), _Tcw(lateral[5]))
    regimes.add(eng.programs.regime(_Tcw(lateral[5])))
    assert len(regimes) == 1
    (r,) = regimes
    assert set(eng.programs.cache) == {("set_reference", torch.uint8, None, None),
                                       ("update", torch.uint8, None, r),
                                       ("update", torch.float32, None, r)}
