"""The collectives of the mesh, each in the group of one axis (the
``lax`` collectives of the JAX package's ``shard_map`` programs):

  - ``lax.psum`` / ``pmax`` / ``pmin``   -> ``all_reduce``;
  - ``lax.all_gather(tiled=True)``       -> ``all_gather`` (a list in axis
    order; the caller concatenates);
  - ``lax.ppermute`` rings               -> ``permute`` (``batch_isend_irecv``
    with the axis neighbours);
  - the export of a keyframe's tiles     -> ``gather`` to the axis's first
    rank.

The backend follows the layout (``backend_for``): NCCL when every rank of a
host has a card of its own, gloo when ranks share a card or run on the CPU.
gloo is given host tensors: a CUDA tensor is copied to pinned host memory
before the collective and the result back to the card after it. Those
copies are explicit and counted in ``mesh.staged``; the compute stays on the
card. A group of one rank is no collective at all.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def backend_for(device_type: str, local_ranks: int) -> str:
    """NCCL when each of a host's ``local_ranks`` ranks has a card of its
    own, else gloo (ranks sharing a card, or CPU ranks)."""
    if device_type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _staging(mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def _count(mesh, t: torch.Tensor) -> None:
    mesh.staged["copies"] += 1
    mesh.staged["bytes"] += t.numel() * t.element_size()


def to_wire(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend takes it: a contiguous copy (the collectives
    write in place), in pinned host memory when gloo is given a CUDA
    tensor."""
    if not _staging(mesh, t):
        return t.contiguous().clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    _count(mesh, t)
    return host


def from_wire(mesh, t: torch.Tensor) -> torch.Tensor:
    """A collective's result back on this rank's device."""
    if t.device == mesh.device:
        return t
    _count(mesh, t)
    return t.to(mesh.device)


def _empty_wire(mesh, like: torch.Tensor) -> torch.Tensor:
    dev = "cpu" if _staging(mesh, like) else like.device
    return torch.empty(like.shape, dtype=like.dtype, device=dev)


def all_reduce(mesh, x: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum", "max", "min") of ``x`` over the ranks of ``axis``
    ("world": every rank)."""
    if (mesh.size == 1) if axis == "world" else (axis not in mesh.groups):
        return x
    w = to_wire(mesh, x)
    dist.all_reduce(w, op=_OPS[op], group=None if axis == "world" else mesh.groups[axis])
    return from_wire(mesh, w)


def all_gather(mesh, x: torch.Tensor, axis: str) -> list[torch.Tensor]:
    """Every rank's ``x`` along ``axis``, in axis order."""
    if axis not in mesh.groups:
        return [x]
    w = to_wire(mesh, x)
    out = [torch.empty_like(w) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(out, w, group=mesh.groups[axis])
    return [from_wire(mesh, t) for t in out]


def gather(mesh, x: torch.Tensor, axis: str) -> list[torch.Tensor] | None:
    """Every rank's ``x`` along ``axis``, in axis order, on the axis's first
    rank; None on the others."""
    if axis not in mesh.groups:
        return [x]
    w = to_wire(mesh, x)
    ranks = mesh.axis_ranks(axis)
    lead = mesh.rank == ranks[0]
    out = [torch.empty_like(w) for _ in ranks] if lead else None
    dist.gather(w, out, dst=ranks[0], group=mesh.groups[axis])
    return [from_wire(mesh, t) for t in out] if lead else None


def permute(mesh, axis: str, sends: dict, recvs: dict) -> dict:
    """Point-to-point exchange inside the group of ``axis``: ``sends`` maps a
    peer's global rank to the tensor it gets, ``recvs`` a peer's global rank
    to a tensor shaped like the one it sends. Returns the received tensors
    by peer. Every message of a call goes to a distinct peer."""
    if not sends and not recvs:
        return {}
    group = mesh.groups[axis]
    ops = [dist.P2POp(dist.isend, to_wire(mesh, t), peer, group) for peer, t in sends.items()]
    got = {peer: _empty_wire(mesh, like) for peer, like in recvs.items()}
    ops += [dist.P2POp(dist.irecv, t, peer, group) for peer, t in got.items()]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return {peer: from_wire(mesh, t) for peer, t in got.items()}
