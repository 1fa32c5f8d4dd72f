"""The mesh's compiled programs (``parallel/programs.py``) on gloo CPU ranks:
the programs path against the eager sharded functions it captures, bit for
bit, at (1, 1, 1), (1, 2, 2) and (2, 1, 2), in the lateral, forward and
zero-baseline regimes, for the reseeds and for the TV-L1; against the JAX
package's sharded step at ``test_torch_sharded.py``'s tolerances; the host
regime (``sharded_regime``) against the device's (``_degenerate`` and the
``kf`` max); the exchange-point sequences equal on every rank; the node
through the programs against the node through the eager functions. On the
CPU a program runs its body through its exchange points' static buffers
and copies, as the card runs it between graph segments (the card itself:
``tests/test_torch_graphs_sharded_cuda.py``). The 160x120 scene of
``tests/test_torch_sharded.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpg_open_remode_tpu.config import RemodeConfig
from rpg_open_remode_tpu.models.state import SceneParams, empty_state
from rpg_open_remode_tpu.ops import seed_init
from rpg_open_remode_tpu.parallel import build_sharded_update, make_mesh, shard_state, stack_states
from rpg_open_remode_tpu.utils import synthetic
from rpg_open_remode_tpu.utils.camera import PinholeCamera
import rpg_open_remode_tpu_torch as P
from rpg_open_remode_tpu_torch.parallel import join_state_numpy, run_ranks, sharded_regime
from rpg_open_remode_tpu_torch.parallel.sharded import _degenerate
from rpg_open_remode_tpu_torch.utils import se3
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera as TorchCamera
from torch_parity import jax_state_numpy

import torch_mesh_cases

torch.set_num_threads(2)
CAM = dict(fx=120.3, fy=-120.0, cx=79.5, cy=59.5)
H, W = 120, 160
CFG = dict(num_planes=48, denoise_iters=10)
SHAPES = ((1, 1, 1), (1, 2, 2), (2, 1, 2))
# the frames stepped, in order
SEQUENCE = ("lateral", "forward", "zero_baseline", "lateral_again")


def _Tcw(Twc):
    return np.asarray(np.linalg.inv(np.concatenate([Twc, [[0, 0, 0, 1]]]))[:3], np.float32)


def _bounds(fr):
    d = fr.depth[np.isfinite(fr.depth)]
    return float(d.min()), float(d.max())


@pytest.fixture(scope="module")
def start():
    """Two keyframes (frames 0 and 2) seeded by the JAX package, as a
    batched numpy state, and the frames of ``SEQUENCE``."""
    frames = synthetic.generate(n_frames=8, width=W, height=H, cam=CAM, seed=5)
    cam = PinholeCamera.create(**CAM)
    cfg = RemodeConfig(**CFG)
    states = []
    for ref_idx in (0, 2):
        f = frames[ref_idx]
        scene = SceneParams.create(*_bounds(f), cfg)
        states.append(seed_init.init_seeds(empty_state(H, W, cam), jnp.asarray(f.image),
                                           jnp.asarray(f.T_world_curr), scene, cfg))
    T_wc = np.concatenate([frames[0].T_world_curr, [[0, 0, 0, 1]]])
    fwd = np.eye(4, dtype=np.float32)
    fwd[2, 3] = 0.08          # dolly forward: the epipole at the image centre
    seq = [(frames[5].image, _Tcw(frames[5].T_world_curr)),
           (frames[1].image, np.asarray(np.linalg.inv(T_wc @ fwd)[:3], np.float32)),
           (frames[0].image, _Tcw(frames[0].T_world_curr)),   # keyframe 0's own pose
           (frames[6].image, _Tcw(frames[6].T_world_curr))]
    return dict(frames=frames, states=states, arrays=jax_state_numpy(stack_states(states)),
                seq=seq, cam=cam, cfg=cfg)


@pytest.fixture(scope="module")
def runs(start):
    """Each layout's ranks: the steps, the reseeds and the TV-L1, both
    ways."""
    arrays, new = start["arrays"], start["frames"][4]
    todo = {
        "steps": ("programs_steps", (arrays, CFG, CAM, start["seq"])),
        "reseed": ("programs_reseed_denoise", (arrays, CFG, CAM, 1, new.image,
                                               new.T_world_curr.astype(np.float32),
                                               _bounds(new), 0.5)),
    }
    return {shape: run_ranks(torch_mesh_cases.jobs, shape, (todo,), device="cpu", timeout=600)
            for shape in SHAPES}


def _assert_blocks_equal(got, want):
    for name in want:
        if name == "scene":
            for k in want[name]:
                np.testing.assert_array_equal(got[name][k], want[name][k], err_msg=k)
        else:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_programs_step_matches_eager(runs, shape):
    n_local = 2 // shape[0]
    for r, rank in enumerate(runs[shape]):
        first = r // (shape[1] * shape[2]) * n_local
        for label, f in zip(SEQUENCE, rank["steps"]["frames"]):
            _assert_blocks_equal(f["programs"], f["eager"])
            np.testing.assert_array_equal(f["packed"], f["eager_packed"], err_msg=label)
            # what local_stats reads from the static packed output
            np.testing.assert_array_equal(f["stats"]["packed"],
                                          f["packed"][first:first + n_local])
            np.testing.assert_array_equal(f["stats"]["update"],
                                          f["packed"][first:first + n_local, 0])


@pytest.mark.parametrize("shape", SHAPES)
def test_host_regime_matches_device_on_the_sequence(runs, shape):
    """Every frame: the host's choice is the device's, on every rank, and
    each branch ran: both slots rectified, both through the plane sweep,
    and (zero baseline: keyframe 0 seen from its own pose, keyframe 1 with a
    baseline) one of each, which the kf max joins on a kf = 2 mesh."""
    for rank in runs[shape]:
        got = [f["host_regime"] for f in rank["steps"]["frames"]]
        assert got == [f["device_regime"] for f in rank["steps"]["frames"]]
        if shape[0] == 1:
            assert got == [(False, False), (True, True), (True, False), (False, False)]
        else:
            assert got == [(False,), (True,), (True,), (False,)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["flat", "propagated"])
def test_programs_reseed_matches_eager(start, runs, shape, kind):
    new = start["frames"][4]
    lo, hi = (np.float32(b) for b in _bounds(new))
    for rank in runs[shape]:
        r = rank["reseed"][kind]
        for got in r["programs"]:     # the first call and the second
            _assert_blocks_equal(got, r["eager"])
        # every rank's table holds slot 1's new keyframe pose and mean
        # depth, slot 0's as it was
        np.testing.assert_array_equal(r["refs"][1, :12], new.T_world_curr.astype(np.float32)
                                      .reshape(-1))
        assert r["refs"][1, 12] == (lo + hi) / np.float32(2.0)
        np.testing.assert_array_equal(r["refs"][0, :12],
                                      start["arrays"]["T_world_ref"][0].reshape(-1))


@pytest.mark.parametrize("shape", SHAPES)
def test_programs_denoise_matches_eager(runs, shape):
    """The TV-L1 of the snapshots, and on each spatial leader what the
    program gathered: the eager gather of the slots' fields and denoised
    tiles."""
    leaders = 0
    for rank in runs[shape]:
        r = rank["reseed"]["denoise"]
        for got in r["programs"]:
            np.testing.assert_array_equal(got, r["eager"])
        assert len(r["gathered"]) == (0 if r["eager_gathered"] is None else 2)
        for got in r["gathered"]:
            np.testing.assert_array_equal(got, r["eager_gathered"])
            leaders += 1
    assert leaders == 2 * shape[0]


@pytest.mark.parametrize("shape", SHAPES)
def test_exchange_points_equal_on_every_rank(runs, shape):
    """Every rank met the same exchange points in the same order, in every
    program; a one-rank world meets none."""
    ranks = runs[shape]
    seqs = [dict(r["steps"]["sequences"], **r["reseed"]["denoise"]["sequences"]) for r in ranks]
    assert all(s == seqs[0] for s in seqs)
    counts = {label: len(s) for label, s in seqs[0].items()}
    if shape == (1, 1, 1):
        assert set(counts.values()) == {0}
    else:
        assert all(n > 0 for n in counts.values()), counts
        kinds = {kind for s in seqs[0].values() for kind, _ in s}
        assert {"all_gather", "all_reduce", "permute"} <= kinds, kinds
    if shape == (1, 2, 2):
        # the TV-L1 of both local slots: three 2-D halo exchanges an
        # iteration, each x then y; then each slot gathered to the leader
        (den,) = [s for label, s in seqs[0].items() if label.startswith("denoise")]
        assert den == ([("permute", "tx"), ("permute", "ty")] * 3 * CFG["denoise_iters"] * 2
                       + [("gather", "sp")] * 2)


def test_programs_step_matches_jax(start, runs):
    """The programs path at (2, 1, 2), lateral frame, against the JAX
    package's sharded step at the same mesh, at test_torch_sharded.py's
    tolerances."""
    mesh = make_mesh(4, kf=2, ty=1, tx=2)
    img, T = start["seq"][0]
    step = build_sharded_update(mesh, start["cam"], start["cfg"], H, W)
    st, stats = step(shard_state(stack_states(start["states"]), mesh), jnp.asarray(img),
                     jnp.asarray(T))
    want, want_packed = jax_state_numpy(st), np.asarray(stats["packed"])
    ranks = runs[(2, 1, 2)]
    got = join_state_numpy([r["steps"]["frames"][0]["programs"] for r in ranks], (2, 1, 2))
    for k in range(2):
        conv, wconv = got["conv"][k], want["conv"][k]
        assert (conv == wconv).mean() >= 0.999
        close = np.abs(got["mu"][k] - want["mu"][k]) <= 1e-5 + 1e-4 * np.abs(want["mu"][k])
        assert close.mean() >= 0.999
        both = (conv == 0) & (wconv == 0)
        np.testing.assert_allclose(got["mu"][k][both], want["mu"][k][both], rtol=5e-3,
                                   atol=1e-3)
    np.testing.assert_array_equal(ranks[0]["steps"]["frames"][0]["packed"], want_packed)


def _near_threshold_poses(rng, avg_depth):
    """Seeded T_curr_ref poses on either side of each threshold: the
    zero-baseline length ``1e-5 avg_depth + 1e-9`` (a lateral move, so no
    epipole test fires) and the epipole box ``|fx e_x| < 0.75 W |e_z|``,
    ``|fy e_y| < 0.75 H |e_z|`` (a move with a forward part)."""
    out = []
    thr = 1e-5 * avg_depth + 1e-9
    for scale in (0.9, 0.99, 1.01, 1.1):
        d = rng.standard_normal(2)
        t = np.array([d[0], d[1], 0.0]) / np.linalg.norm(d) * thr * scale
        out.append(t)
    for axis, size, f in ((0, W, CAM["fx"]), (1, H, CAM["fy"])):
        for scale in (0.9, 0.99, 1.01, 1.1):
            t = np.zeros(3)
            t[2] = 0.05 * (1 + rng.random())
            t[axis] = 0.75 * size * t[2] / abs(f) * scale
            out.append(t)
    poses = []
    for t in out:
        angle = 1e-3 * rng.standard_normal(3)
        K = np.array([[0, -angle[2], angle[1]], [angle[2], 0, -angle[0]],
                      [-angle[1], angle[0], 0]])
        R = np.eye(3) + K + 0.5 * K @ K
        poses.append(np.concatenate([R, t[:, None]], axis=1).astype(np.float32))
    return poses


def _device_regime(T_curr_world, refs, kf):
    """``_degenerate`` of each slot on CPU tensors, then the max over the
    kf rows that share a local index."""
    cfg = P.RemodeConfig(**CFG)
    cam = TorchCamera.create(CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"], device="cpu")
    deg = []
    for T_ref, avg in refs:
        T = se3.compose(torch.tensor(T_curr_world), torch.tensor(T_ref))
        scene = P.SceneParams.create(0.0, 2 * float(avg), cfg, device="cpu")
        deg.append(int(_degenerate(T, scene, cam, cfg, H, W)))
    n_local = len(deg) // kf
    return tuple(max(deg[k * n_local + i] for k in range(kf)) > 0 for i in range(n_local))


def test_sharded_regime_matches_device(start):
    """Every frame of the lateral and the forward sequence, and seeded poses
    near each threshold with two slots of which only one is degenerate (the
    second slot's keyframe a lateral step away): the host's choice is the
    device's, per slot (kf = 1) and joined over kf = 2."""
    rng = np.random.default_rng(11)
    slot0 = np.eye(4, dtype=np.float32)[:3]
    slot1 = slot0.copy()
    slot1[0, 3] = 0.3
    poses = _near_threshold_poses(rng, 1.5)
    forward = synthetic.generate(n_frames=6, width=W, height=H, cam=CAM, seed=3,
                                 motion="forward")
    seq = [_Tcw(fr.T_world_curr) for fr in list(start["frames"]) + forward]
    refs_seq = [(_Tcw(start["frames"][i].T_world_curr), np.float32(1.5)) for i in (0, 2)]
    cases = [(T, [(slot0, np.float32(1.5)), (slot1, np.float32(1.5))]) for T in poses]
    cases += [(T, refs_seq) for T in seq]
    mixed = 0
    for T, refs in cases:
        for kf in (1, 2):
            got = sharded_regime(T, refs, (CAM["fx"], CAM["fy"]), P.RemodeConfig(**CFG), H, W, kf)
            assert got == _device_regime(T, refs, kf), (T, kf)
        mixed += sharded_regime(T, refs, (CAM["fx"], CAM["fy"]), P.RemodeConfig(**CFG), H, W,
                                1) in ((True, False), (False, True))
    assert mixed >= 8
    # no choice to make: None
    for kw in (dict(zero_baseline_fallback=False), dict(match_mode="walk")):
        assert sharded_regime(poses[0], refs_seq, (CAM["fx"], CAM["fy"]),
                              P.RemodeConfig(**kw), H, W) is None


def test_sharded_regime_matches_device_kf_max_on_ranks(start):
    """The same poses on a (2, 1, 2) mesh, where the device's choice is the
    real ``all_reduce`` max over ``kf``."""
    poses = _near_threshold_poses(np.random.default_rng(12), 1.5)
    arrays = dict(start["arrays"])
    T_ref = np.stack([np.eye(4, dtype=np.float32)[:3]] * 2)
    T_ref[1, 0, 3] = 0.3
    arrays["T_world_ref"] = T_ref
    arrays["scene"] = dict(arrays["scene"], avg_depth=np.full(2, 1.5, np.float32))
    out = run_ranks(torch_mesh_cases.regime_compare, (2, 1, 2), (arrays, CFG, CAM, poses),
                    device="cpu", timeout=300)
    for rank in out:
        assert [h for h, _ in rank] == [d for _, d in rank]
        assert rank == out[0]
    assert {h for h, _ in out[0]} == {(True,), (False,)}


@pytest.fixture(scope="module")
def node_runs():
    """The node at (2, 1, 2) with propagation, through the programs and
    through the eager functions (``torch_mesh_cases.node_compare``)."""
    frames = synthetic.generate(n_frames=40, width=W, height=H, cam=CAM, seed=5)
    feed = [(fr.image, _Tcw(fr.T_world_curr), _bounds(fr)) for fr in frames]
    cfg_kw = dict(num_planes=48, denoise_iters=10, propagate_depth=True)
    return run_ranks(torch_mesh_cases.node_compare, (2, 1, 2), (feed, CAM, cfg_kw, None, 3, 8),
                     device="cpu", timeout=600)


def test_node_through_programs_matches_eager_node(node_runs):
    """The node at (2, 1, 2) with propagation, through the programs and
    through the eager functions (``torch_mesh_cases.EagerPrograms``): the
    same switches, update counts and exports bit for bit; each export holds
    its keyframe's own pose and scene, not the ones the reseed that followed
    it wrote into the slot's buffers."""
    out = node_runs
    for rank in out:
        got, want = rank["programs"], rank["eager"]
        assert got["switches"] == want["switches"] and got["switches"]
        assert got["updates"] == want["updates"]
        assert len(got["keyframes"]) == len(want["keyframes"])
        for g, w in zip(got["keyframes"], want["keyframes"]):
            assert g[0] == w[0] and g[3] == w[3] and g[4] == w[4]
            _assert_blocks_equal(g[1], w[1])
            np.testing.assert_array_equal(g[2], w[2])
        # the spatial leader's exports follow its slot's switches in order
        for (slot, T_after, avg_after), k in zip(got["after"], got["keyframes"]):
            assert not np.array_equal(k[1]["T_world_ref"], T_after)
            assert k[1]["scene"]["avg_depth"] != avg_after
    assert out[0]["programs"]["keyframes"] and out[2]["programs"]["keyframes"]


def test_node_finalization_reseeds_before_the_denoise(node_runs):
    """Every finalization, on every rank: the snapshot of the rank's
    finalizing slots, then every finalizing slot's reseed, each followed by
    its host-copy event (which the next frame's regime read waits on),
    then the denoise of the snapshots on the slot's kf row, then on the
    row's spatial leader one export per slot; nothing else before the next
    step. So the next frame's regime read never waits for the TV-L1."""
    finalized = 0
    for r, rank in enumerate(node_runs):
        calls = rank["programs"]["calls"]
        starts = [i for i, (name, _) in enumerate(calls) if name == "snapshot"]
        assert starts
        for i in starts:
            end = next((j for j in range(i, len(calls)) if calls[j][0] == "step"), len(calls))
            seq = calls[i:end]
            mine = seq[0][1]
            k = 1
            while k < len(seq) and seq[k][0] == "reseed":
                assert seq[k + 1] == ("_refresh_host", None), seq
                k += 2
            assert k > 1, seq
            rest = seq[k:]
            if not mine:
                assert rest == [], seq
                continue
            assert rest[0] == ("denoise", mine), seq
            leader = r % 2 == 0     # (2, 1, 2): the first rank of each kf row
            assert rest[1:] == ([("export", i) for i in mine] if leader else []), seq
            finalized += 1
    assert finalized >= 4
