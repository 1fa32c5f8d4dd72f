"""Starting the ranks of a mesh: one spawned process per rank of this host.

JAX starts one process per host and addresses all of its devices from it;
the port starts one process per mesh position. ``RankGroup`` spawns this
host's ranks, joins them into one ``torch.distributed`` world over a TCP
store at ``coordinator`` (rank 0's host), builds each rank's ``Mesh`` and
calls ``fn(mesh, io, *args)`` there. ``io.post`` sends a message back to
this process (``RankGroup.poll``); ``io.inputs()`` yields what
``RankGroup.send`` sends to every rank, so one frame source can feed all
of a host's ranks. ``fn`` must be importable (spawn pickles it by name).

Rank ``r`` of the host runs on card ``r mod device_count``; ``device=None``
means CUDA and raises without it, as the engine's ``resolve_device`` does,
and ``"cpu"`` puts every rank on the CPU. The kernels are built here,
before the ranks start, so that the ranks do not each compile them.
"""

from __future__ import annotations

import gc
import multiprocessing
import os
import queue
import socket
import time
import traceback

import numpy as np

_POLL_S = 0.05


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class RankIO:
    """A rank's line to the process that launched it."""

    def __init__(self, out_q, in_q, rank: int):
        self._out, self._in, self.rank = out_q, in_q, rank

    def post(self, payload) -> None:
        self._out.put(("msg", self.rank, payload))

    def inputs(self):
        """What the launching process sends, until it sends its end."""
        while True:
            item = self._in.get()
            if item is None:
                return
            yield item


def _rank_main(fn, args, shape, rank, local_index, local_ranks, hosts, device_type,
               coordinator, out_q, in_q):
    import torch
    import torch.distributed as dist

    from rpg_open_remode_tpu_torch.parallel.distributed import initialize
    from rpg_open_remode_tpu_torch.parallel.mesh import make_mesh

    try:
        if coordinator.split(":")[0] in ("localhost", "127.0.0.1"):
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        if device_type == "cuda":
            device = torch.device("cuda", local_index % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
        torch.set_num_threads(max(1, min(2, (os.cpu_count() or 1) // local_ranks)))
        initialize(coordinator, int(np.prod(shape)), rank, device, local_ranks)
        mesh = make_mesh(kf=shape[0], ty=shape[1], tx=shape[2], device=device, hosts=hosts)
        result = fn(mesh, RankIO(out_q, in_q, rank), *args)
        dist.barrier()
        out_q.put(("done", rank, result))
    except BaseException:
        out_q.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            # a CUDA graph that captured NCCL calls holds their communicator,
            # and NCCL's destroy waits until every such graph is gone: free
            # the programs fn left behind first
            if device_type == "cuda":
                torch.cuda.synchronize()
            gc.collect()
            dist.destroy_process_group()


class RankGroup:
    """This host's ranks of a ``shape`` = (kf, ty, tx) mesh: global ranks
    ``first_rank`` .. ``first_rank + local_ranks - 1`` of ``hosts`` hosts
    (default: the whole mesh on this host, coordinated on a free localhost
    port). Use as a context manager; leaving it ends every rank still
    running."""

    def __init__(self, fn, shape, args=(), device=None, coordinator: str | None = None,
                 first_rank: int = 0, local_ranks: int | None = None, hosts: int = 1,
                 inputs: bool = False):
        from rpg_open_remode_tpu_torch.models.depthmap import resolve_device

        device = resolve_device(device).type
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        self.shape = tuple(int(v) for v in shape)
        world = int(np.prod(self.shape))
        self.local_ranks = local_ranks or world
        self.first_rank = first_rank
        self.device = device
        self.coordinator = coordinator or f"localhost:{free_port()}"
        ctx = multiprocessing.get_context("spawn")
        self._out = ctx.Queue()
        self._in = [ctx.Queue(maxsize=4) if inputs else None for _ in range(self.local_ranks)]
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                fn, args, self.shape, first_rank + i, i, self.local_ranks, hosts, device,
                self.coordinator, self._out, self._in[i]))
            for i in range(self.local_ranks)
        ]
        self._results = {}

    def __enter__(self):
        if self.device == "cuda":
            from rpg_open_remode_tpu_torch import kernels

            kernels.build()
        for p in self._procs:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=30)
        return False

    def devices(self) -> list[str]:
        """Each local rank's device, as the ranks choose it."""
        if self.device != "cuda":
            return ["cpu"] * self.local_ranks
        import torch

        n = torch.cuda.device_count()
        return [f"cuda:{i % n}" if n else "cuda" for i in range(self.local_ranks)]

    def poll(self, on_message=None, timeout: float = 0.0) -> None:
        """Handle the ranks' messages that arrive within ``timeout`` seconds
        (``on_message(rank, payload)``); raises when a rank failed."""
        wait = timeout
        while True:
            try:
                kind, rank, payload = self._out.get(timeout=max(wait, 1e-3))
            except queue.Empty:
                break
            wait = 0.0
            if kind == "msg":
                if on_message is not None:
                    on_message(rank, payload)
            elif kind == "done":
                self._results[rank] = payload
            else:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
        for i, p in enumerate(self._procs):
            r = self.first_rank + i
            if p.exitcode not in (None, 0) and r not in self._results:
                raise RuntimeError(f"rank {r} exited with code {p.exitcode}")

    def send(self, item, on_message=None) -> None:
        """Give ``item`` to every local rank's ``io.inputs()``, handling
        messages while a rank's queue is full."""
        for q in self._in:
            while True:
                try:
                    q.put(item, timeout=_POLL_S)
                    break
                except queue.Full:
                    self.poll(on_message)

    def join(self, on_message=None, timeout: float | None = None) -> list:
        """End the ranks' inputs (if any), wait for every local rank's result
        and return them in rank order."""
        if self._in[0] is not None:
            self.send(None, on_message)
        t0 = time.monotonic()
        while len(self._results) < self.local_ranks:
            self.poll(on_message, timeout=_POLL_S)
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(f"ranks still running after {timeout} s")
        for p in self._procs:
            p.join(timeout=60)
        return [self._results[self.first_rank + i] for i in range(self.local_ranks)]


def run_ranks(fn, shape, args=(), device=None, timeout: float | None = None, **kw) -> list:
    """Run ``fn(mesh, io, *args)`` on every rank of a ``shape`` mesh on this
    host; returns the ranks' results in rank order."""
    with RankGroup(fn, shape, args, device=device, **kw) as group:
        return group.join(timeout=timeout)
