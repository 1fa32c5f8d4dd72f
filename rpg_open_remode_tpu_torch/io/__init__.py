"""Host IO of the port: dataset reading, point clouds, checkpoints
(counterpart of ``rpg_open_remode_tpu/io``, with the same exports)."""

from rpg_open_remode_tpu_torch.io.dataset import Dataset, DatasetEntry, FramePrefetcher
from rpg_open_remode_tpu_torch.io.checkpoint import save_state, load_state
from rpg_open_remode_tpu_torch.io.pointcloud import (
    GlobalMap,
    backproject_converged,
    save_pointcloud_ply,
    save_pointcloud_npz,
    convergence_overlay,
    voxel_downsample,
)

__all__ = [
    "Dataset",
    "GlobalMap",
    "voxel_downsample",
    "DatasetEntry",
    "save_state",
    "load_state",
    "backproject_converged",
    "save_pointcloud_ply",
    "save_pointcloud_npz",
    "convergence_overlay",
]
