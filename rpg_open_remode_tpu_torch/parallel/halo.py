"""Halo exchange between neighbouring tiles (counterpart of
``rpg_open_remode_tpu/parallel/halo.py``).

The communication behind spatial sharding: the plane sweep's NCC box sums
need a patch-radius halo of the reference image, and the sharded TV-L1
needs a 1-px halo per iteration. At the global image border the halo is
edge-replicated (the reference's clamp-addressed texture reads). The JAX
ring (``lax.ppermute`` to ``(idx +- 1) % n``) discards what wraps around at
the border; here only the real neighbours exchange.
"""

from __future__ import annotations

import torch

from rpg_open_remode_tpu_torch.parallel import collectives


def _take(x, axis, start, size):
    return x.narrow(axis, start if start >= 0 else x.shape[axis] + start, size)


def _repeat_edge(x, axis, first: bool, halo: int):
    edge = _take(x, axis, 0, 1) if first else _take(x, axis, -1, 1)
    return torch.cat([edge] * halo, dim=axis)


def exchange_halo_1d(x: torch.Tensor, halo: int, axis: int, axis_name: str, mesh) -> torch.Tensor:
    """Extend this rank's tile with ``halo`` neighbour slices along ``axis``
    (tensor dim) from the ranks before and after it on mesh axis
    ``axis_name``. Returns the shape grown by ``2 * halo`` on ``axis``."""
    n = mesh.axis_size(axis_name)
    idx = mesh.axis_index(axis_name)
    ranks = mesh.axis_ranks(axis_name)
    hi_edge = _take(x, axis, -halo, halo)   # my last rows -> the next rank
    lo_edge = _take(x, axis, 0, halo)       # my first rows -> the previous rank
    sends, recvs = {}, {}
    if idx > 0:
        sends[ranks[idx - 1]] = lo_edge
        recvs[ranks[idx - 1]] = hi_edge
    if idx < n - 1:
        sends[ranks[idx + 1]] = hi_edge
        recvs[ranks[idx + 1]] = lo_edge
    got = collectives.permute(mesh, axis_name, sends, recvs)
    from_left = got[ranks[idx - 1]] if idx > 0 else _repeat_edge(x, axis, True, halo)
    from_right = got[ranks[idx + 1]] if idx < n - 1 else _repeat_edge(x, axis, False, halo)
    return torch.cat([from_left, x, from_right], dim=axis)


def exchange_halo_2d(x: torch.Tensor, halo: int, mesh, y_axis: int = -2,
                     x_axis: int = -1) -> torch.Tensor:
    """2-D halo exchange including corners: x first, then y on the
    x-extended tile, so the diagonal neighbours' corners arrive through the
    y pass."""
    ext = exchange_halo_1d(x, halo, x_axis % x.ndim, "tx", mesh)
    return exchange_halo_1d(ext, halo, y_axis % x.ndim, "ty", mesh)
