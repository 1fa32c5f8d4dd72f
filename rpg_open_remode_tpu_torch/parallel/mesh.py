"""The device mesh of the port (counterpart of
``rpg_open_remode_tpu/parallel/mesh.py``).

Axes, as in the JAX package:
  - ``kf``: concurrent reference keyframes;
  - ``ty``, ``tx``: spatial tiling of the ``[H, W]`` seed state;
  - ``sp``: the flattened spatial axis ``(ty, tx)``, whose index
    ``ty_idx * n_tx + tx_idx`` is the rect band a rank matches
    (``parallel/rect_sharded.py``).

JAX runs one program over a ``Mesh`` of devices with ``shard_map``. The
port runs one process (a ``torch.distributed`` rank) per mesh position,
rank order row-major over ``(kf, ty, tx)``: kf is the slowest axis, as
``make_distributed_mesh`` lays devices out, so the ranks of one keyframe
row are consecutive. Every rank creates the process group of every axis
line once, in the same order; each collective of the port runs in the
group of one axis (``parallel/collectives.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from rpg_open_remode_tpu_torch.utils.devices import validate_mesh_shape

AXES = ("kf", "ty", "tx", "sp")


def _factor3(n: int) -> tuple[int, int, int]:
    """Default (kf, ty, tx) factorization of n devices: prefer spatial."""
    kf = 1
    ty = 1
    tx = n
    t = int(np.sqrt(n))
    while t > 1:
        if n % t == 0:
            ty, tx = t, n // t
            break
        t -= 1
    return kf, ty, tx


def mesh_shape(n: int, kf: int | None = None, ty: int | None = None,
               tx: int | None = None) -> tuple[int, int, int]:
    """``(kf, ty, tx)`` of a mesh of ``n`` positions, the missing axes
    filled as the JAX ``make_mesh`` fills them; raises if they do not
    multiply to ``n``."""
    if kf is None or ty is None or tx is None:
        dkf, dty, _ = _factor3(n)
        kf = kf or dkf
        ty = ty or dty
        tx = tx or (n // (kf * ty))
    validate_mesh_shape(n, kf, ty, tx)
    return kf, ty, tx


def rank_of(shape, k: int, y: int, x: int) -> int:
    """Global rank of mesh position ``(k, y, x)``."""
    return (k * shape[1] + y) * shape[2] + x


def coords_of(shape, rank: int) -> tuple[int, int, int]:
    """Mesh position ``(k, y, x)`` of a global rank."""
    k, rest = divmod(rank, shape[1] * shape[2])
    y, x = divmod(rest, shape[2])
    return k, y, x


def axis_size(shape, axis: str) -> int:
    kf, ty, tx = shape
    return {"kf": kf, "ty": ty, "tx": tx, "sp": ty * tx}[axis]


def axis_ranks(shape, axis: str, coords) -> list[int]:
    """The ranks of the ``axis`` line through ``coords``, in axis order
    (for ``sp``: band order)."""
    k, y, x = coords
    kf, ty, tx = shape
    if axis == "kf":
        return [rank_of(shape, i, y, x) for i in range(kf)]
    if axis == "ty":
        return [rank_of(shape, k, i, x) for i in range(ty)]
    if axis == "tx":
        return [rank_of(shape, k, y, i) for i in range(tx)]
    return [rank_of(shape, k, i, j) for i in range(ty) for j in range(tx)]


def _axis_lines(shape, axis: str) -> list[list[int]]:
    """Every line of ``axis`` through the mesh, each once, in a fixed order."""
    lines = []
    for r in range(int(np.prod(shape))):
        ranks = axis_ranks(shape, axis, coords_of(shape, r))
        if ranks[0] == r:
            lines.append(ranks)
    return lines


@dataclasses.dataclass
class Mesh:
    """This rank's view of the ``(kf, ty, tx)`` mesh: its position, its
    device, the backend, the process groups of the axis lines through it
    (none for an axis of size 1), and the host copies that the collectives
    staged (``parallel/collectives.py``). ``hosts`` is the number of host
    processes that launched the ranks (``--distributed``); the ranks of one
    host are consecutive."""

    shape: tuple[int, int, int]
    rank: int
    device: torch.device
    backend: str
    hosts: int = 1
    groups: dict = dataclasses.field(default_factory=dict, repr=False)
    staged: dict = dataclasses.field(default_factory=lambda: {"copies": 0, "bytes": 0})

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def coords(self) -> tuple[int, int, int]:
        return coords_of(self.shape, self.rank)

    def axis_size(self, axis: str) -> int:
        return axis_size(self.shape, axis)

    def axis_index(self, axis: str) -> int:
        k, y, x = self.coords
        return {"kf": k, "ty": y, "tx": x, "sp": y * self.shape[2] + x}[axis]

    def axis_ranks(self, axis: str) -> list[int]:
        return axis_ranks(self.shape, axis, self.coords)

    def host_of(self, rank: int) -> int:
        return rank // (self.size // self.hosts)

    @property
    def host(self) -> int:
        return self.host_of(self.rank)

    def tile(self, height: int, width: int) -> tuple[int, int, int, int]:
        """``(y0, x0, tile_h, tile_w)`` of this rank's tile of an ``[H, W]``
        grid; the grid must tile evenly."""
        _, ty, tx = self.shape
        if height % ty or width % tx:
            raise ValueError(f"{height}x{width} does not tile evenly over ty={ty}, tx={tx}")
        th, tw = height // ty, width // tx
        _, y, x = self.coords
        return y * th, x * tw, th, tw


def assemble_tiles(tiles, n_tx: int) -> torch.Tensor:
    """The full grid from tiles in band order (``[..., th, tw]`` each)."""
    rows = [torch.cat(tiles[i:i + n_tx], dim=-1) for i in range(0, len(tiles), n_tx)]
    return torch.cat(rows, dim=-2)


def make_mesh(n_devices: int | None = None, kf: int | None = None, ty: int | None = None,
              tx: int | None = None, device=None, hosts: int = 1) -> Mesh:
    """The ``(kf, ty, tx)`` mesh over the initialized ``torch.distributed``
    world, one rank per position; missing axes are factored as the JAX
    ``make_mesh`` factors them. ``device`` is this rank's device (None: the
    current CUDA device; raises without CUDA). Every rank must call it, with
    the same arguments."""
    world = dist.get_world_size()
    n = n_devices or world
    kf, ty, tx = mesh_shape(n, kf, ty, tx)
    if n != world:
        raise ValueError(f"mesh of {n} positions over a world of {world} ranks")
    if world % hosts:
        raise ValueError(f"{world} ranks do not split over {hosts} hosts")
    if device is None:
        from rpg_open_remode_tpu_torch.models.depthmap import resolve_device

        resolve_device(None)
        device = torch.device("cuda", torch.cuda.current_device())
    shape = (kf, ty, tx)
    mesh = Mesh(shape=shape, rank=dist.get_rank(), device=torch.device(device),
                backend=dist.get_backend(), hosts=hosts)
    for axis in AXES:
        if axis_size(shape, axis) == 1:
            continue
        for ranks in _axis_lines(shape, axis):
            group = dist.new_group(ranks)
            if mesh.rank in ranks:
                mesh.groups[axis] = group
    return mesh
