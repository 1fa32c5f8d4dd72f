"""Multi-host execution (counterpart of
``rpg_open_remode_tpu/parallel/distributed.py``).

In the JAX package a host runs one process that addresses all of its
devices; here every mesh position is a process of its own, so these are the
per-rank counterparts:

  * ``initialize`` joins this process to the ``torch.distributed`` world
    over a TCP store (``tcp://COORD:PORT``, rank 0's host);
  * ``make_distributed_mesh`` lays the mesh kf-major over the ranks, so
    whole keyframe rows sit on one host when the hosts divide the rows;
  * ``replicate_frame`` / ``shard_local_keyframes`` feed a rank: the frame
    every rank loads, and its tiles of its kf row's keyframes;
  * ``local_block`` / ``local_stats`` give this rank's part of the state
    and the stats as numpy;
  * ``gather_kf_slot`` assembles a local slot's field on the kf row's
    spatial leader.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from rpg_open_remode_tpu_torch.models.state import state_to_numpy
from rpg_open_remode_tpu_torch.parallel import collectives
from rpg_open_remode_tpu_torch.parallel.mesh import Mesh, _factor3, assemble_tiles, make_mesh

# how long a rank waits for the others, to join the world and in a collective
_RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=600)


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               device: torch.device, local_ranks: int | None = None) -> str:
    """Join rank ``process_id`` of a world of ``num_processes`` ranks at
    ``coordinator_address`` (``host:port``), this rank on ``device``. The
    backend follows ``collectives.backend_for``: NCCL when each of this
    host's ``local_ranks`` (default: all) ranks has a card, else gloo.
    Returns the backend."""
    device = torch.device(device)
    backend = collectives.backend_for(device.type, local_ranks or num_processes)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=_RENDEZVOUS_TIMEOUT,
                            device_id=device if backend == "nccl" else None)
    return backend


def make_distributed_mesh(kf: int | None = None, ty: int | None = None, tx: int | None = None,
                          device=None, hosts: int = 1) -> Mesh:
    """The ``(kf, ty, tx)`` mesh over the world, kf-major (rank order is
    row-major over kf, ty, tx, and the ranks of a host are consecutive):
    keyframe rows stay on one host whenever the hosts divide them. ``kf``
    defaults to the number of hosts, the spatial axes to the JAX
    factorization of the rest."""
    n = dist.get_world_size()
    if kf is None:
        kf = hosts
    rest = n // kf
    if kf * rest != n:
        raise ValueError(f"kf={kf} does not divide {n} ranks")
    if ty is None and tx is None:
        _, ty, tx = _factor3(rest)
    elif ty is None:
        ty = rest // tx
    elif tx is None:
        tx = rest // ty
    return make_mesh(n, kf=kf, ty=ty, tx=tx, device=device, hosts=hosts)


def replicate_frame(mesh: Mesh, frame) -> torch.Tensor:
    """The current frame, which every rank loads from its own input, on this
    rank's device."""
    return torch.as_tensor(np.asarray(frame)).to(mesh.device)


def shard_local_keyframes(mesh: Mesh, states_local: list, n_kf_global: int) -> list:
    """This rank's tiles of its kf row's keyframes: ``states_local`` holds
    the row's ``n_kf_global / kf`` full-grid ``SeedState``s, in slot
    order."""
    from rpg_open_remode_tpu_torch.parallel.sharded import tile_state

    if len(states_local) * mesh.axis_size("kf") != n_kf_global:
        raise ValueError(f"{len(states_local)} local keyframes x kf={mesh.axis_size('kf')} "
                         f"!= {n_kf_global}")
    return [tile_state(st, mesh) for st in states_local]


def local_block(states: list) -> dict:
    """This rank's local slots as one batched numpy state (leading
    ``[KF_local]`` axis, image fields tile-sized): its part for
    ``sharded.join_state_numpy``."""
    per = [state_to_numpy(st) for st in states]
    out = {k: np.stack([p[k] for p in per]) for k in per[0] if k != "scene"}
    out["scene"] = {k: np.stack([p["scene"][k] for p in per]) for k in per[0]["scene"]}
    return out


def local_stats(mesh: Mesh, stats: dict) -> dict:
    """The stats of this rank's local slots as numpy (``packed``: the rows
    of its kf row)."""
    out = {k: v.cpu().numpy() for k, v in stats.items() if k != "packed"}
    n_local = len(out["update"])
    first = mesh.axis_index("kf") * n_local
    out["packed"] = stats["packed"][first:first + n_local].cpu().numpy()
    return out


def gather_kf_slot(mesh: Mesh, x_tile: torch.Tensor) -> torch.Tensor | None:
    """A local slot's field (``x_tile``, ``[..., th, tw]``) assembled to the
    full grid on the kf row's spatial leader, on its device; None on the
    row's other ranks. Every rank of the row calls it alike."""
    tiles = collectives.gather(mesh, x_tile, "sp")
    return None if tiles is None else assemble_tiles(tiles, mesh.shape[2])
