"""TV-L1 solve: CUDA kernel (``csrc/tvl1.cu``, a few iterations per launch
on shared-memory tiles) and its plain PyTorch version.

One kernel replaces both Pallas kernels of
``rpg_open_remode_tpu/ops/denoise_pallas.py`` (``_kernel``, all iterations
in VMEM, and ``_tiled_kernel``, 64-row bands for frames beyond the VMEM
budget): they compute the same iteration, ``ops/denoise.tvl1_iteration``.
"""

from __future__ import annotations

import ctypes

import torch

from rpg_open_remode_tpu_torch import kernels
from rpg_open_remode_tpu_torch.config import RemodeConfig
from rpg_open_remode_tpu_torch.ops.denoise import shrink_threshold, tvl1_iteration


def tvl1_plain(noisy, g, lam: float, iterations: int, cfg: RemodeConfig) -> torch.Tensor:
    """``iterations`` of ``tvl1_iteration`` from u = u_head = noisy, p = 0."""
    u = u_head = noisy
    p_x = p_y = torch.zeros_like(noisy)
    for _ in range(iterations):
        u, u_head, p_x, p_y = tvl1_iteration(u, u_head, p_x, p_y, noisy, g, lam, cfg)
    return u


def tvl1(noisy, g, lam: float, iterations: int, cfg: RemodeConfig) -> torch.Tensor:
    """The TV-L1 solve: the CUDA kernel on CUDA tensors (the source says
    how many launches it makes and so which buffer holds the result), the
    plain version on CPU tensors. ``noisy``/``g``: [H, W]."""
    if not noisy.is_cuda:
        return tvl1_plain(noisy, g, lam, iterations, cfg)
    h, w = noisy.shape
    kernels.require(noisy, "noisy")
    kernels.require(g, "g", (h, w))
    a = [noisy.clone(), noisy.clone(), torch.zeros_like(noisy), torch.zeros_like(noisy)]
    b = [torch.empty_like(noisy) for _ in range(4)]
    launches = ctypes.c_int(0)
    err = kernels.library().remode_tvl1(
        noisy.data_ptr(), g.data_ptr(), *(t.data_ptr() for t in a),
        *(t.data_ptr() for t in b), h, w, int(iterations),
        float(cfg.tv_sigma), float(cfg.tv_tau), float(cfg.tv_theta),
        shrink_threshold(lam, cfg), ctypes.pointer(launches), kernels.stream_of(noisy),
    )
    kernels.count("tvl1", launches.value)
    kernels.check(err, "tvl1")
    return a[0] if launches.value % 2 == 0 else b[0]
