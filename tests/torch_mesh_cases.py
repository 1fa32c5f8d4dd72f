"""Rank functions of the port's mesh tests (``tests/test_torch_parallel.py``,
``test_torch_sharded.py``, ``test_torch_sharded_programs.py``,
``test_torch_graphs_sharded_cuda.py``): each runs on every rank of a
spawned ``torch.distributed`` mesh
(``rpg_open_remode_tpu_torch.parallel.run_ranks``: gloo on the CPU; on the
card gloo or NCCL) and returns numpy. Spawned ranks import this module by name, so it imports nothing of
JAX."""

import dataclasses

import numpy as np
import torch

from rpg_open_remode_tpu_torch.config import RemodeConfig
from rpg_open_remode_tpu_torch.models.state import SceneParams, state_to_numpy
from rpg_open_remode_tpu_torch.ops import epipolar
from rpg_open_remode_tpu_torch.parallel import (
    ShardedDepthmapNode, ShardedPrograms, build_sharded_denoise, build_sharded_reseed,
    build_sharded_update, collectives, exchange_halo_1d, exchange_halo_2d,
    make_distributed_mesh, make_mesh, shard_state, sharded_regime,
)
from rpg_open_remode_tpu_torch.parallel.distributed import gather_kf_slot, local_block, local_stats
from rpg_open_remode_tpu_torch.parallel.programs import GATHERED
from rpg_open_remode_tpu_torch.parallel.sharded import _degenerate
from rpg_open_remode_tpu_torch.utils import se3
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera


def _cam(mesh, cam):
    return PinholeCamera.create(cam["fx"], cam["fy"], cam["cx"], cam["cy"], device=mesh.device)


def device_regime(mesh, states, T_curr_world, cam, cfg, height, width):
    """The sharded step's regime decided on the device, as the JAX step
    decides it: ``_degenerate`` of each local slot (``cam`` a
    ``PinholeCamera``), then an ``all_reduce`` max over ``kf`` and a host
    read; None where the config has no choice to make. The oracle of
    ``sharded_regime``."""
    if not (cfg.match_mode == "rect" and cfg.zero_baseline_fallback):
        return None
    return tuple(bool(collectives.all_reduce(mesh, _degenerate(
        se3.compose(T_curr_world, st.T_world_ref), st.scene, cam, cfg, height, width), "kf",
        "max") > 0) for st in states)


def box_filter(mesh, io, x, halo):
    """This rank's tile of the 5x5 clamped box sum of ``x`` (a ty x tx
    mesh), through a ``halo``-px 2-D halo exchange."""
    y0, x0, th, tw = mesh.tile(*x.shape)
    ext = exchange_halo_2d(torch.tensor(x[y0:y0 + th, x0:x0 + tw]), halo, mesh)
    s = sum(ext[:, i:i + tw] for i in range(2 * halo + 1))
    return sum(s[i:i + th] for i in range(2 * halo + 1)).numpy()


def collectives_suite(mesh, io, x):
    """The collectives, the halo exchange and ``make_mesh`` on this world:
    what each returns on this rank."""
    r = torch.tensor([float(mesh.rank + 1)])
    tx_ranks = mesh.axis_ranks("tx")
    peer = tx_ranks[(mesh.axis_index("tx") + 1) % len(tx_ranks)]
    prev = tx_ranks[(mesh.axis_index("tx") - 1) % len(tx_ranks)]
    gathered = collectives.gather(mesh, r, "sp")
    return dict(
        coords=mesh.coords, groups=sorted(mesh.groups),
        box=box_filter(mesh, io, x, 2),
        sums={op: {ax: float(collectives.all_reduce(mesh, r, ax, op))
                   for ax in ("world", "kf", "ty", "tx", "sp")} for op in ("sum", "max", "min")},
        all_gather_sp=[float(t) for t in collectives.all_gather(mesh, r, "sp")],
        gather_sp=None if gathered is None else [float(t) for t in gathered],
        ring=float(collectives.permute(mesh, "tx", {peer: r}, {prev: r})[prev]),
        halo_ty=exchange_halo_1d(torch.full((2, 3), float(mesh.rank)), 1, 0, "ty", mesh).numpy(),
        default_shape=make_mesh(device="cpu").shape, staged=dict(mesh.staged),
        distributed=(lambda m: (m.shape, m.host))(make_distributed_mesh(device="cpu", hosts=2)),
        fed=_fed(mesh, x),
    )


def _fed(mesh, x):
    """``replicate_frame`` and ``shard_local_keyframes`` on a state whose
    fields are ``x``: this rank's copy of the frame and its tiles."""
    from rpg_open_remode_tpu_torch.models.state import empty_state
    from rpg_open_remode_tpu_torch.parallel import replicate_frame, shard_local_keyframes

    h, w = x.shape
    full = dataclasses.replace(empty_state(h, w, _cam(mesh, dict(fx=20.0, fy=-20.0, cx=11.5,
                                                                 cy=7.5))),
                               mu=torch.tensor(x), conv=torch.tensor(x > 0.5).int())
    tiles = shard_local_keyframes(mesh, [full], mesh.axis_size("kf"))
    return dict(frame=replicate_frame(mesh, x).numpy(), mu=tiles[0].mu.numpy(),
                conv=tiles[0].conv.numpy(), f_ref=tiles[0].f_ref.numpy(),
                f_ref_full=full.f_ref.numpy())


def fail_on(mesh, io, bad_rank):
    """Raises on rank ``bad_rank`` before any collective."""
    if mesh.rank == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    return mesh.rank


def steps(mesh, io, arrays, cfg_kw, cam, frames):
    """One sharded step from ``arrays`` (a batched numpy state) for each
    ``(image, T_curr_world)`` of ``frames``; per frame this rank's tiles,
    its stats and how many tile plane sweeps ran."""
    cfg = RemodeConfig(**cfg_kw)
    h, w = arrays["mu"].shape[-2:]
    c = _cam(mesh, cam)
    step = build_sharded_update(mesh, c, cfg, h, w)
    sweeps = [0]
    plain = epipolar.match_planesweep_tile

    def counted(*args):
        sweeps[0] += 1
        return plain(*args)

    epipolar.match_planesweep_tile = counted
    out = []
    for img, T in frames:
        sweeps[0] = 0
        states = shard_state(arrays, mesh)
        T = torch.tensor(T)
        states, stats = step(states, torch.tensor(img), T,
                             device_regime(mesh, states, T, c, cfg, h, w))
        out.append(dict(state=local_block(states), stats=local_stats(mesh, stats),
                        packed=stats["packed"].numpy(), sweeps=sweeps[0]))
    return out


def denoise(mesh, io, arrays, cfg_kw, iterations, lam):
    """This rank's denoised tiles of every local slot of ``arrays``."""
    cfg = RemodeConfig(**cfg_kw)
    h, w = arrays["mu"].shape[-2:]
    run = build_sharded_denoise(mesh, cfg, h, w, iterations=iterations)
    return np.stack([t.numpy() for t in run(shard_state(arrays, mesh), lam)])


def reseed(mesh, io, arrays, cfg_kw, cam, slot, img, T_world_ref, bounds):
    """This rank's tiles after re-seeding global slot ``slot``."""
    cfg = RemodeConfig(**cfg_kw)
    h, w = arrays["mu"].shape[-2:]
    fn = build_sharded_reseed(mesh, _cam(mesh, cam), cfg, h, w)
    scene = SceneParams.create(*bounds, cfg, device=mesh.device)
    return local_block(fn(shard_state(arrays, mesh), slot, img, T_world_ref, scene))


def jobs(mesh, io, todo):
    """Several cases in one world: ``todo`` maps a label to (function name
    in this module, its arguments); returns the results by label."""
    return {label: globals()[fn](mesh, io, *args) for label, (fn, args) in todo.items()}


def node_run(mesh, io, frames, cam, cfg_kw, n_keyframes, policy_stride, stagger):
    """A ``ShardedDepthmapNode`` over ``frames`` (image, T_curr_world,
    bounds); the keyframes this rank exported (index, numpy state, denoised
    depth, converged %, updates) and the switches."""
    h, w = frames[0][0].shape
    node = ShardedDepthmapNode(mesh, w, h, cam["fx"], cam["cx"], cam["fy"], cam["cy"],
                               n_keyframes=n_keyframes, cfg=RemodeConfig(**cfg_kw),
                               policy_stride=policy_stride, stagger=stagger)
    for img, T, bounds in frames:
        node.process_frame(img, T, *bounds)
    node.close()
    return dict(switches=node.switches, keyframes=[
        (k.index, state_to_numpy(k.state), k.denoised_depth, k.converged_percentage,
         k.n_updates) for k in node.keyframes])


def _programs(mesh, arrays, cfg, cam):
    """``ShardedPrograms`` of every slot of ``arrays``, loaded with it."""
    h, w = arrays["mu"].shape[-2:]
    progs = ShardedPrograms(mesh, h, w, _cam(mesh, cam), (cam["fx"], cam["fy"]), cfg,
                            len(arrays["mu"]))
    progs.load_numpy(arrays)
    return progs


def _sequences(progs) -> dict:
    """Each cached program's exchange points, (collective, mesh axis) in
    order, by its label."""
    return {p.label: [ex.signature[:2] for ex in p.exchanges] for p in progs.cache.values()}


def _forms(progs) -> dict:
    """Each cached program's form by its label: (graphs, exchange points,
    collectives, replays); no graph on the CPU."""
    return {p.label: (0 if p.graph is None else len(p.graph), len(p.exchanges),
                      len(p.signatures), p.replays) for p in progs.cache.values()}


def programs_steps(mesh, io, arrays, cfg_kw, cam, frames):
    """The programs path and the eager sharded step from ``arrays``, frame
    after frame: per frame both paths' tiles and packed stats, the host
    regime and the device's (``_degenerate`` of each local slot, the
    ``kf`` max); at the end each program's exchange-point sequence."""
    cfg = RemodeConfig(**cfg_kw)
    h, w = arrays["mu"].shape[-2:]
    step = build_sharded_update(mesh, _cam(mesh, cam), cfg, h, w)
    progs = _programs(mesh, arrays, cfg, cam)
    states = shard_state(arrays, mesh)
    out = []
    for img, T in frames:
        T_dev = torch.tensor(T)
        dev_regime = device_regime(mesh, states, T_dev, progs.cam, cfg, h, w)
        host_regime = progs.regime(np.asarray(T, np.float32))
        states, stats = step(states, torch.tensor(img), T_dev, dev_regime)
        got = progs.update(img, T)
        out.append(dict(eager=local_block(states), programs=local_block(progs.states),
                        eager_packed=stats["packed"].numpy(), packed=got["packed"].numpy(),
                        stats=local_stats(mesh, progs.stats()), host_regime=host_regime,
                        device_regime=dev_regime))
    return dict(frames=out, sequences=_sequences(progs))


def programs_reseed_denoise(mesh, io, arrays, cfg_kw, cam, slot, img, T_world_ref, bounds,
                            lam):
    """Global slot ``slot`` reseeded flat and propagated from ``arrays``, and
    the TV-L1 of every local slot of ``arrays``, through the programs (each
    called twice, the second a replay) and eagerly: this rank's tiles."""
    cfg = RemodeConfig(**cfg_kw)
    h, w = arrays["mu"].shape[-2:]
    out = {}
    for propagated in (False, True):
        c = dataclasses.replace(cfg, propagate_depth=propagated)
        fn = build_sharded_reseed(mesh, _cam(mesh, cam), c, h, w)
        scene = SceneParams.create(*bounds, c, device=mesh.device)
        want = local_block(fn(shard_state(arrays, mesh), slot, torch.tensor(img),
                              torch.tensor(T_world_ref), scene))
        progs = _programs(mesh, arrays, c, cam)
        got = []
        for _ in range(2):
            progs.load_numpy(arrays)
            progs.load_frame(img, np.eye(4, dtype=np.float32)[:3])
            progs.load_bounds(*bounds)
            progs.reseed(slot, T_world_ref)
            got.append(local_block(progs.states))
        key = "propagated" if propagated else "flat"
        out[key] = dict(eager=want, programs=got, refs=progs.refs.cpu().numpy(),
                        sequences=_sequences(progs), forms=_forms(progs))
    den = build_sharded_denoise(mesh, cfg, h, w, iterations=cfg.denoise_iters)
    slots = list(range(len(arrays["mu"]) // mesh.axis_size("kf")))
    states = shard_state(arrays, mesh)
    want = np.stack([t.cpu().numpy() for t in den(states, lam, slots)])
    progs = _programs(mesh, arrays, cfg, cam)
    got, gathered = [], []
    for _ in range(2):
        progs.snapshot(slots)
        got.append(np.stack([t.cpu().numpy() for t in progs.denoise(slots, lam)]))
        if progs.leader:
            gathered.append(progs.gathered.cpu().numpy())
    out["denoise"] = dict(eager=want, programs=got, sequences=_sequences(progs),
                          forms=_forms(progs), gathered=gathered,
                          eager_gathered=_eager_gathered(mesh, states, slots, want))
    return out


def _eager_gathered(mesh, states, slots, denoised):
    """What the denoise program gathers, eagerly: each local slot's
    ``GATHERED`` fields and denoised tile assembled on the spatial leader;
    None elsewhere."""
    out = []
    for i, den in zip(slots, denoised):
        fields = [getattr(states[i], f).float() for f in GATHERED]
        full = gather_kf_slot(mesh, torch.stack(fields + [torch.as_tensor(den).to(mesh.device)]))
        out.append(None if full is None else full.cpu().numpy())
    return None if out[0] is None else np.stack(out)


class EagerPrograms(ShardedPrograms):
    """The node's programs as the eager functions they capture (the node as
    it ran before its programs): a step, reseed or denoise makes new
    tensors, and the regime is decided on the device (``device_regime``)."""

    def step(self, T_host):
        regime = device_regime(self.mesh, self.states, self.inputs.pose, self.cam, self.cfg,
                               self.height, self.width)
        self.states, stats = self._step_fn(self.states, self.inputs.images[self.dtype],
                                           self.inputs.pose, regime)
        self.packed = stats["packed"]

    def load_bounds(self, min_depth, max_depth):
        self._bounds = (min_depth, max_depth)

    def reseed(self, slot, T_world_ref):
        fn = build_sharded_reseed(self.mesh, self.cam, self.cfg, self.height, self.width)
        scene = SceneParams.create(*self._bounds, self.cfg, device=self.device)
        self.states = fn(self.states, slot, self.inputs.images[self.dtype], T_world_ref, scene)

    def snapshot(self, slots):
        self.snaps = list(self.states)   # the reseeds make new states

    def denoise(self, slots, lam):
        self.finalize(self.snaps, slots, lam)
        return [self.denoised[i] for i in slots]


def _record_calls(progs, calls: list) -> None:
    """Append (method, its first argument) to ``calls`` at every call of
    the programs' step, reseed, host-copy refresh, snapshot, denoise and
    export."""
    for name in ("step", "reseed", "_refresh_host", "snapshot", "denoise", "export"):
        def wrapped(*args, _f=getattr(progs, name), _name=name):
            first = args[0] if args else None
            calls.append((_name, list(first) if isinstance(first, list) else
                          first if isinstance(first, int) else None))
            return _f(*args)
        setattr(progs, name, wrapped)


def node_compare(mesh, io, frames, cam, cfg_kw, n_keyframes, policy_stride, stagger):
    """``node_run`` through the programs and through ``EagerPrograms``, per
    export of the programs' run the keyframe pose and mean depth that its
    slot holds after the reseed that followed it, and the programs' calls
    in order (``_record_calls``)."""
    out = {}
    for eager in (False, True):
        h, w = frames[0][0].shape
        node = ShardedDepthmapNode(mesh, w, h, cam["fx"], cam["cx"], cam["fy"], cam["cy"],
                                   n_keyframes=n_keyframes, cfg=RemodeConfig(**cfg_kw),
                                   policy_stride=policy_stride, stagger=stagger)
        calls = []
        if eager:
            p = node.programs
            node.programs = EagerPrograms(mesh, h, w, p.cam, p.cam_host, p.cfg, p.n)
        else:
            _record_calls(node.programs, calls)
        after = []
        seen = 0
        for img, T, bounds in frames:
            node.process_frame(img, T, *bounds)
            while seen < len(node.switches):
                slot = node.switches[seen][1]
                local = node._local(slot)
                if local is not None:
                    st = node.programs.states[local]
                    after.append((slot, st.T_world_ref.numpy().copy(),
                                  float(st.scene.avg_depth)))
                seen += 1
        node.close()
        out["eager" if eager else "programs"] = dict(
            switches=node.switches, updates=list(node._n_updates), after=after, calls=calls,
            keyframes=[(k.index, state_to_numpy(k.state), k.denoised_depth,
                        k.converged_percentage, k.n_updates) for k in node.keyframes])
    return out


def regime_compare(mesh, io, arrays, cfg_kw, cam, poses):
    """For each host pose: ``sharded_regime`` and the device's choice
    (``_degenerate`` of each local slot, the ``kf`` max)."""
    cfg = RemodeConfig(**cfg_kw)
    h, w = arrays["mu"].shape[-2:]
    c = _cam(mesh, cam)
    states = shard_state(arrays, mesh)
    slots = [(arrays["T_world_ref"][i], arrays["scene"]["avg_depth"][i])
             for i in range(len(arrays["mu"]))]
    out = []
    for T in poses:
        dev = device_regime(mesh, states, torch.tensor(T), c, cfg, h, w)
        host = sharded_regime(T, slots, (cam["fx"], cam["fy"]), cfg, h, w, mesh.axis_size("kf"))
        out.append((host, dev))
    return out


def graphs_vs_eager(mesh, io, arrays, cfg_kw, cam, frames, single=False):
    """On the rank's device: the programs path and the eager sharded step
    from ``arrays``, frame after frame (the programs' first call warms up
    and captures, the later ones replay): per frame both paths' tiles and
    packed stats and what each added to the kernel launch counts and to
    ``mesh.staged``; each program's graphs and exchange points; with
    ``single`` also slot 0 through a single ``Depthmap`` from the same
    start (a (1, 1, 1) mesh: the full grid)."""
    from rpg_open_remode_tpu_torch import kernels
    from rpg_open_remode_tpu_torch.models.depthmap import Depthmap
    from rpg_open_remode_tpu_torch.models.state import state_from_numpy

    cfg = RemodeConfig(**cfg_kw)
    h, w = arrays["mu"].shape[-2:]
    dev = mesh.device
    c = _cam(mesh, cam)
    step = build_sharded_update(mesh, c, cfg, h, w)
    progs = _programs(mesh, arrays, cfg, cam)
    states = shard_state(arrays, mesh)
    eng = None
    if single:
        eng = Depthmap(w, h, cam["fx"], cam["cx"], cam["fy"], cam["cy"], cfg=cfg, device=dev)
        eng.state = state_from_numpy({k: v[0] if k != "scene" else {f: x[0] for f, x in v.items()}
                                      for k, v in arrays.items()}, device=dev)

    def counts():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return dict(kernels.LAUNCHES), dict(mesh.staged)

    def delta(a, b):
        return {k: b[0][k] - a[0][k] for k in a[0]}, {k: b[1][k] - a[1][k] for k in a[1]}

    out = []
    for img, T in frames:
        T_dev = torch.tensor(T, device=dev)
        regime = device_regime(mesh, states, T_dev, c, cfg, h, w)
        c0 = counts()
        states, stats = step(states, torch.tensor(img, device=dev), T_dev, regime)
        c1 = counts()
        got = progs.update(img, T)
        c2 = counts()
        row = dict(eager=local_block(states), programs=local_block(progs.states),
                   eager_packed=stats["packed"].cpu().numpy(), packed=got["packed"].cpu().numpy(),
                   eager_counts=delta(c0, c1), counts=delta(c1, c2))
        if eng is not None:
            eng.update(img, T)
            row["single"] = state_to_numpy(eng.state)
        out.append(row)
    return dict(frames=out, backend=mesh.backend,
                programs={p.label: (len(p.graph), len(p.exchanges), p.replays)
                          for p in progs.cache.values()},
                collectives={p.label: [sig[:2] for sig in p.signatures]
                             for p in progs.cache.values()})
