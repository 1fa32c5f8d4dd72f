"""Helpers shared by the tests/test_torch_*.py parity tests."""

import dataclasses

import numpy as np


def jax_state_numpy(state) -> dict:
    """A JAX ``SeedState``'s leaves as numpy arrays, in the layout
    ``rpg_open_remode_tpu_torch.state_from_numpy`` takes."""
    out = {f.name: np.asarray(getattr(state, f.name))
           for f in dataclasses.fields(state) if f.name != "scene"}
    out["scene"] = {f.name: np.asarray(getattr(state.scene, f.name))
                    for f in dataclasses.fields(state.scene)}
    return out
