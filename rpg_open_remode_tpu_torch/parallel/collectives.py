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

Inside a compiled program of the mesh
(``parallel/programs.SegmentedProgram``) the backend decides the form, as
``mesh.backend`` alone says:

  * NCCL (a card per rank): the collective runs inline on the current
    stream, as outside a program, so the capture takes it into the graph
    with the body (the JAX ``shard_map`` programs' form): a program is one
    graph, replayed with no host work between its parts. The program holds
    the body's collectives to the warm-up's, in order.
  * gloo (ranks sharing a card, or CPU ranks), which cannot be captured:
    each collective is an exchange point between two graph segments. The
    program's first call creates one ``Exchange`` per collective it meets,
    with static send and receive buffers (pinned host memory where gloo
    stages a CUDA tensor, else on the rank's device). Each call then copies
    the input into the send buffer, ends the segment (while capturing) or
    runs the collective on the static buffers (the host waits for the copy
    first), and copies the receive buffer into the tensor it returns at the
    head of the next segment. A replay runs the segments with each
    ``Exchange.run`` between them and adds its staged copies to
    ``mesh.staged`` as the eager call would.

Outside a program the collectives run as described above.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
_program = threading.local()   # .current: the program this thread is running, or None


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


@contextlib.contextmanager
def exchange_points(program):
    """Route this thread's collectives through ``program``: each is held to
    the warm-up's (``program.collective(signature)``); under gloo
    ``program.exchange_point(signature, make)`` returns its point and
    ``program.exchange_boundary(point)`` ends a segment or runs it."""
    saved = getattr(_program, "current", None)
    _program.current = program
    try:
        yield
    finally:
        _program.current = saved


class Exchange:
    """One exchange point: a collective on static buffers. ``call(send,
    recv)`` runs it on the buffer lists; ``recv_likes`` None means in place
    (the receive buffers are the send buffers)."""

    def __init__(self, mesh, signature, sends, recv_likes, call):
        self.mesh = mesh
        self.signature = signature
        self.call = call
        stage = mesh.backend == "gloo" and mesh.device.type == "cuda"

        def static(shape, dtype):
            if stage:
                return torch.empty(shape, dtype=dtype, pin_memory=True)
            return torch.empty(shape, dtype=dtype, device=mesh.device)

        self.send = [static(t.shape, t.dtype) for t in sends]
        self.recv = self.send if recv_likes is None else [static(*like) for like in recv_likes]
        wire = self.send + self.recv
        # what the eager call stages: each input out, each result back
        self.staged = (len(wire) if stage else 0,
                       sum(t.numel() * t.element_size() for t in wire) if stage else 0)
        self._event = torch.cuda.Event() if stage else None

    def stage_in(self, tensors) -> None:
        """Copy the inputs into the send buffers (captured in a program)."""
        for buf, t in zip(self.send, tensors):
            buf.copy_(t, non_blocking=True)

    def run(self) -> None:
        """The collective on the static buffers, after the copies into them
        that the current stream has queued."""
        if self._event is not None:
            self._event.record(torch.cuda.current_stream(self.mesh.device))
            self._event.synchronize()
        self.call(self.send, self.recv)
        self.mesh.staged["copies"] += self.staged[0]
        self.mesh.staged["bytes"] += self.staged[1]

    def stage_out(self) -> list[torch.Tensor]:
        """The received tensors on the rank's device (captured in a
        program: the head of the next segment)."""
        return [torch.empty(r.shape, dtype=r.dtype, device=self.mesh.device).copy_(
            r, non_blocking=True) for r in self.recv]


def _collect(mesh, kind: str, axis: str, sends: list, recv_likes, call) -> list:
    """Run collective ``call(send_wires, recv_wires)`` on ``sends``: eagerly
    (inline in the program this thread runs, under NCCL), or through the
    program's exchange point (under gloo). Returns the received tensors on
    the rank's device."""
    program = getattr(_program, "current", None)
    signature = (kind, axis, tuple((tuple(t.shape), t.dtype) for t in sends),
                 None if recv_likes is None else tuple(recv_likes))
    if program is None or mesh.backend == "nccl":
        if program is not None:
            program.collective(signature)
        wires = [to_wire(mesh, t) for t in sends]
        recv = wires if recv_likes is None else [
            torch.empty(shape, dtype=dtype, device=wires[0].device) for shape, dtype in recv_likes]
        call(wires, recv)
        return [from_wire(mesh, t) for t in recv]
    point = program.exchange_point(
        signature, lambda: Exchange(mesh, signature, sends, recv_likes, call))
    point.stage_in(sends)
    program.exchange_boundary(point)
    return point.stage_out()


def all_reduce(mesh, x: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum", "max", "min") of ``x`` over the ranks of ``axis``
    ("world": every rank)."""
    if (mesh.size == 1) if axis == "world" else (axis not in mesh.groups):
        return x
    group = None if axis == "world" else mesh.groups[axis]

    def call(send, recv):
        dist.all_reduce(send[0], op=_OPS[op], group=group)

    return _collect(mesh, "all_reduce", axis, [x], None, call)[0]


def all_gather(mesh, x: torch.Tensor, axis: str) -> list[torch.Tensor]:
    """Every rank's ``x`` along ``axis``, in axis order."""
    if axis not in mesh.groups:
        return [x]
    group = mesh.groups[axis]

    def call(send, recv):
        dist.all_gather(recv, send[0], group=group)

    like = (tuple(x.shape), x.dtype)
    return _collect(mesh, "all_gather", axis, [x], [like] * mesh.axis_size(axis), call)


def gather(mesh, x: torch.Tensor, axis: str) -> list[torch.Tensor] | None:
    """Every rank's ``x`` along ``axis``, in axis order, on the axis's first
    rank; None on the others."""
    if axis not in mesh.groups:
        return [x]
    group = mesh.groups[axis]
    ranks = mesh.axis_ranks(axis)
    lead = mesh.rank == ranks[0]

    def call(send, recv):
        dist.gather(send[0], recv if lead else None, dst=ranks[0], group=group)

    likes = [(tuple(x.shape), x.dtype)] * len(ranks) if lead else []
    out = _collect(mesh, "gather", axis, [x], likes, call)
    return out if lead else None


def permute(mesh, axis: str, sends: dict, recvs: dict) -> dict:
    """Point-to-point exchange inside the group of ``axis``: ``sends`` maps a
    peer's global rank to the tensor it gets, ``recvs`` a peer's global rank
    to a tensor shaped like the one it sends. Returns the received tensors
    by peer. Every message of a call goes to a distinct peer."""
    if not sends and not recvs:
        return {}
    group = mesh.groups[axis]
    to, frm = list(sends), list(recvs)

    def call(send, recv):
        ops = [dist.P2POp(dist.isend, t, peer, group) for peer, t in zip(to, send)]
        ops += [dist.P2POp(dist.irecv, t, peer, group) for peer, t in zip(frm, recv)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    got = _collect(mesh, "permute", axis, list(sends.values()),
                   [(tuple(t.shape), t.dtype) for t in recvs.values()], call)
    return dict(zip(frm, got))
