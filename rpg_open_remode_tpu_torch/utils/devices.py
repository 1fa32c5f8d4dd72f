"""Device discovery and validation (counterpart of
``rpg_open_remode_tpu/utils/devices.py``; the reference's checkCudaDevice,
src/check_cuda_device.cu:23-117): enumerate the CUDA devices, report them
(``card_info``: a card's name and power limit, as every measurement of the
port records them), and validate mesh shapes for the parallel paths."""

from __future__ import annotations

import subprocess

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


def card_info(device) -> dict:
    """The card behind ``device`` as ``nvidia-smi --query-gpu=name,power.limit``
    reports it: ``device_name`` and ``power_limit_w`` (W). The card is found
    by its UUID, which torch and nvidia-smi share (their indices differ
    under a remapping ``CUDA_VISIBLE_DEVICES``). A CPU device gives
    ``"cpu"`` and None."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device_name": "cpu", "power_limit_w": None}
    index = torch.cuda.current_device() if dev.index is None else dev.index
    uuid = str(torch.cuda.get_device_properties(index).uuid)
    listing = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    for line in listing.strip().splitlines():
        gpu, rest = line.split(",", 1)
        if gpu.strip().removeprefix("GPU-") == uuid:
            name, limit = (x.strip() for x in rest.rsplit(",", 1))
            return {"device_name": name, "power_limit_w": float(limit.split()[0])}
    raise RuntimeError(f"nvidia-smi lists no card with the UUID {uuid} of {dev}")


def validate_mesh_shape(n_devices: int, kf: int, ty: int, tx: int) -> None:
    if kf * ty * tx != n_devices:
        raise ValueError(
            f"mesh kf={kf} x ty={ty} x tx={tx} != {n_devices} devices"
        )
