"""Keyframe-state checkpoint / resume (counterpart of
``rpg_open_remode_tpu/io/checkpoint.py``; the reference has no persistence).

Format v1, the JAX package's: one ``.npz`` with ``state.<field>`` for every
``SeedState`` field but ``scene``, ``scene.<field>`` for every
``SceneParams`` field, and ``format_version``. A file written by either
package loads in the other, and a resumed engine continues bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rpg_open_remode_tpu_torch.models.depthmap import resolve_device
from rpg_open_remode_tpu_torch.models.state import SceneParams, SeedState

_FORMAT_VERSION = 1


def save_state(path: str, state: SeedState) -> None:
    """Serialize a SeedState to ``.npz`` (one download per field)."""
    arrays = {
        f"state.{f.name}": getattr(state, f.name).cpu().numpy()
        for f in dataclasses.fields(state) if f.name != "scene"
    }
    arrays.update({
        f"scene.{f.name}": getattr(state.scene, f.name).cpu().numpy()
        for f in dataclasses.fields(state.scene)
    })
    arrays["format_version"] = np.asarray(_FORMAT_VERSION)
    np.savez_compressed(path, **arrays)


def load_state(path: str, device=None) -> SeedState:
    """Load a v1 checkpoint onto ``device`` (``None`` means CUDA, and
    raises without it, as ``Depthmap`` does)."""
    dev = resolve_device(device)
    with np.load(path) as data:
        version = int(data["format_version"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        scene = SceneParams(**{
            f.name: torch.from_numpy(data[f"scene.{f.name}"]).to(dev)
            for f in dataclasses.fields(SceneParams)
        })
        kwargs = {
            f.name: torch.from_numpy(data[f"state.{f.name}"]).to(dev)
            for f in dataclasses.fields(SeedState) if f.name != "scene"
        }
    return SeedState(scene=scene, **kwargs)
