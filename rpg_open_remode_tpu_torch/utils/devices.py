"""Device discovery and validation (counterpart of
``rpg_open_remode_tpu/utils/devices.py``; the reference's checkCudaDevice,
src/check_cuda_device.cu:23-117): enumerate the CUDA devices, report them,
and validate mesh shapes for the parallel paths."""

from __future__ import annotations

import torch


def check_devices(min_devices: int = 1, verbose: bool = True) -> list[torch.device]:
    """The CUDA devices, printed by name when ``verbose``. Raises if fewer
    than ``min_devices`` are found; the CPU is never reported as one."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devices = [torch.device("cuda", i) for i in range(n)]
    if verbose:
        print(f"[remode] cuda, {n} device(s):")
        for d in devices:
            print(f"  - id={d.index} {torch.cuda.get_device_name(d)}")
    if n < min_devices:
        raise RuntimeError(f"need >= {min_devices} CUDA devices, found {n}")
    return devices


def validate_mesh_shape(n_devices: int, kf: int, ty: int, tx: int) -> None:
    if kf * ty * tx != n_devices:
        raise ValueError(
            f"mesh kf={kf} x ty={ty} x tx={tx} != {n_devices} devices"
        )
