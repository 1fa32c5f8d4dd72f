"""Rank functions of the port's mesh tests (``tests/test_torch_parallel.py``,
``test_torch_sharded.py``): each runs on every rank of a spawned
``torch.distributed`` mesh (``rpg_open_remode_tpu_torch.parallel.run_ranks``,
gloo, CPU) and returns numpy. Spawned ranks import this module by name, so
it imports nothing of JAX."""

import dataclasses

import numpy as np
import torch

from rpg_open_remode_tpu_torch.config import RemodeConfig
from rpg_open_remode_tpu_torch.models.state import SceneParams, state_to_numpy
from rpg_open_remode_tpu_torch.ops import epipolar
from rpg_open_remode_tpu_torch.parallel import (
    ShardedDepthmapNode, build_sharded_denoise, build_sharded_reseed, build_sharded_update,
    collectives, exchange_halo_1d, exchange_halo_2d, make_distributed_mesh, make_mesh,
    shard_state,
)
from rpg_open_remode_tpu_torch.parallel.distributed import local_block, local_stats
from rpg_open_remode_tpu_torch.utils.camera import PinholeCamera


def _cam(mesh, cam):
    return PinholeCamera.create(cam["fx"], cam["fy"], cam["cx"], cam["cy"], device=mesh.device)


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
    step = build_sharded_update(mesh, _cam(mesh, cam), cfg, h, w)
    sweeps = [0]
    plain = epipolar.match_planesweep_tile

    def counted(*args):
        sweeps[0] += 1
        return plain(*args)

    epipolar.match_planesweep_tile = counted
    out = []
    for img, T in frames:
        sweeps[0] = 0
        states, stats = step(shard_state(arrays, mesh), img, T)
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
